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
    if name == "cartpole_balance":
        from gan_mpc_tpu_torch.envs.cartpole import CartpoleBalance

        return CartpoleBalance(device)
    if name == "walker_walk":
        from gan_mpc_tpu_torch.envs.walker import WalkerWalk

        return WalkerWalk(device)
    if name == "humanoid_stand":
        from gan_mpc_tpu_torch.envs.humanoid import HumanoidStand

        return HumanoidStand(device)
    if name == "humanoid_walk":
        from gan_mpc_tpu_torch.envs.humanoid import HumanoidWalk

        return HumanoidWalk(device)
    raise ValueError(f"unknown environment {name!r} (known: cheetah_run, pendulum_swingup, "
                     "cartpole_balance, walker_walk, humanoid_stand, humanoid_walk)")
