from gan_mpc_tpu_torch.envs.base import (  # noqa: F401
    EnvState,
    apply_physics_shift,
    tolerance,
)


def make_env(name: str, device="cuda"):
    """Environment factory by dm_control-style '{domain}_{task}' name, on
    the card unless ``device`` says otherwise."""
    if name == "cheetah_run":
        from gan_mpc_tpu_torch.envs.cheetah import CheetahRun

        return CheetahRun(device)
    if name == "pendulum_swingup":
        from gan_mpc_tpu_torch.envs.pendulum import PendulumSwingup

        return PendulumSwingup(device)
    if name == "humanoid_stand":
        from gan_mpc_tpu_torch.envs.humanoid import HumanoidStand

        return HumanoidStand(device)
    if name == "humanoid_walk":
        from gan_mpc_tpu_torch.envs.humanoid import HumanoidWalk

        return HumanoidWalk(device)
    raise ValueError(f"environment {name!r} is not ported (ported: cheetah_run, "
                     "pendulum_swingup, humanoid_stand, humanoid_walk)")
