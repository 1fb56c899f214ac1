from gan_mpc_tpu_torch.envs.base import (  # noqa: F401
    EnvState,
    apply_physics_shift,
    tolerance,
)


def make_env(name: str, device="cuda"):
    """Environment factory by dm_control-style '{domain}_{task}' name, on
    the card unless ``device`` says otherwise. Only ``cheetah_run`` is
    ported."""
    if name == "cheetah_run":
        from gan_mpc_tpu_torch.envs.cheetah import CheetahRun

        return CheetahRun(device)
    raise ValueError(f"environment {name!r} is not ported (only 'cheetah_run')")
