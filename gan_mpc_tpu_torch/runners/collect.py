"""Expert trajectory collection with the scripted controllers.

Counterpart of ``gan_mpc_tpu/runners/collect.py`` for the ported envs:
each env ships a scripted expert (pendulum energy-shaping swing-up, the
cart-pole's linear balance feedback, the walker's, the humanoid's and the
cheetah's state-indexed phase-PD gaits, the humanoid's centre-of-mass
balance), and
``collect_expert_trajectories`` rolls it out over a batch of envs and
returns the reference-schema ``TrajectorySet``.

Differences from the JAX module:

  * every expert is batched over envs: ``policy(obs (B, obs)) -> (B, act)``
    on raw observations, in place of ``policy(params, history_x,
    history_u)`` under ``jax.vmap``;
  * the phase-matched gaits compute their grid of target poses and target
    velocities once per expert (``phase_grid``); JAX recomputes them on
    every call under ``jit``;
  * random draws come from a ``torch.Generator`` (on the CPU, then moved to
    the env's device), or are passed in (``init_state``, ``noise``), as the
    parity tests pass the JAX package's. ``jax.random`` cannot be
    reproduced in torch, so a store collected here carries the JAX
    package's fingerprinted name (the same config gives the same
    ``collection_fingerprint``) but not the JAX package's random draws:
    its resets and noise, and so its trajectories, differ.

``collect_dagger_trajectories`` restarts the scripted expert from states
that the imitator's policy visits (DAgger's corrective segments).

Not ported: the open-loop v1 cheetah gait, which no expert version reaches.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

import numpy as np
import torch

from gan_mpc_tpu_torch.data.trajectories import TrajectorySet
from gan_mpc_tpu_torch.envs.base import EnvState
from gan_mpc_tpu_torch.envs.planar import contact_points, forward_kinematics
from gan_mpc_tpu_torch.envs.rollout import policy_rollout
from gan_mpc_tpu_torch.training.common import split

# Bump an env's entry whenever its scripted expert's behaviour changes: the
# collection fingerprint folds it in, so a store labelled by an older
# expert is collected again, not reused. Cheetah's entry depends on its
# variant (``expert_version``).
EXPERT_VERSION = {"pendulum_swingup": 2, "humanoid_walk": 3, "walker_walk": 2}


def cheetah_variant() -> str:
    """The cheetah expert's variant, ``GMT_CHEETAH_EXPERT`` (default
    "nominal"; "shift3" is the gait tuned under the torso x3 shift)."""
    return os.environ.get("GMT_CHEETAH_EXPERT", "nominal")


def expert_version(env_name: str):
    """The scripted expert's version of ``env_name``, as the JAX
    ``EXPERT_VERSION`` gives it (1 for an env without an entry)."""
    if env_name == "cheetah_run":
        variant = cheetah_variant()
        return 2 if variant == "nominal" else f"2-{variant}"
    return EXPERT_VERSION.get(env_name, 1)


def _f32(values, device) -> torch.Tensor:
    return torch.tensor(np.asarray(values, np.float32), device=device)


def phase_grid(targets: Callable, w: torch.Tensor, num: int = 64):
    """The phase grid of a gait: phases (G,), target poses (G, k) and
    target velocities (G, k), the phase derivative of ``targets(w, ph)``
    times the gait's angular frequency 2 pi w[0]."""
    phases = torch.tensor(np.linspace(-np.pi, np.pi, num, endpoint=False), dtype=torch.float32,
                          device=w.device)
    qts = torch.func.vmap(lambda p: targets(w, p))(phases)
    dqts = torch.func.vmap(torch.func.jacfwd(lambda p: targets(w, p)))(phases)
    return phases, qts, dqts * (2.0 * math.pi * w[0])


def match_phase(grid, joints: torch.Tensor, jointsd: torch.Tensor, lam) -> torch.Tensor:
    """Grid argmin over phase of ||qt(ph) - q||^2 + lam ||qt'(ph) - qd||^2
    for each env: (B,) phases (the first of equal minima)."""
    phases, qts, qdts = grid
    err = ((qts - joints[:, None]) ** 2).sum(-1) + lam * ((qdts - jointsd[:, None]) ** 2).sum(-1)
    return phases[torch.argmin(err, dim=-1)]


def _add_columns(u: torch.Tensor, cols, value: torch.Tensor) -> torch.Tensor:
    u = u.clone()
    for c in cols:
        u[:, c] = u[:, c] + value
    return u


# Stand-balance feedback gains found by CEM over the differentiable engine:
#   kp, kd, ank_e, ank_edot, hip_trunk_p, hip_trunk_d, waist_p, waist_d, hip_e
_HUMANOID_STAND_GAINS = (
    0.45, 0.0032, -23.6043, 0.7678, 0.5925, 0.4468, -3.954, -0.4946, -0.8379,
)
# nominal stance: a slight knee bend keeps the knees off their range
# boundary (range [-2, 0]); hips and ankles compensate to stay tall
_HUMANOID_POSE = (0.0, 0.0, 0.08, -0.16, 0.08, 0.08, -0.16, 0.08, 0.0, 0.0, 0.0, 0.0)


def com_offset(obs: torch.Tensor, env):
    """The horizontal offset (B,) of the humanoid's whole-body centre of
    mass from its feet's support centre, by the engine's own forward
    kinematics at the observed pose (root x, which the observation omits,
    set to 0: the offset does not depend on it), and its rate (B,), the
    forward-mode derivative along the observed velocities."""
    model = env.model(env.default_params())

    def com_minus_feet(q):
        angles, origins, coms = forward_kinematics(model, q)
        com_x = (model.mass * coms[..., 0]).sum(-1) / model.mass.sum()
        feet_x = contact_points(model, angles, origins)[:, :4, 0].mean(-1)
        return com_x - feet_x

    q = torch.cat([obs.new_zeros((obs.shape[0], 1)), obs[:, :14]], dim=-1)
    return torch.func.jvp(com_minus_feet, (q,), (obs[:, 14:29],))


def humanoid_balance_policy(g: torch.Tensor, obs: torch.Tensor, env) -> torch.Tensor:
    """Centre-of-mass-over-feet balance controller for the planar humanoid,
    (B, 29) observations -> (B, 12) actions: on top of a nominal-pose PD,
    ankle and hip torque regulate ``com_offset`` and its rate, and hip and
    waist torque the trunk's pitch."""
    e, edot = com_offset(obs, env)
    pitch, pitchd = obs[:, 1], obs[:, 16]
    joints, jointsd = obs[:, 2:14], obs[:, 17:29]
    trunk = pitch + joints[:, 0]  # absolute torso angle
    trunkd = pitchd + jointsd[:, 0]
    u = -g[0] * (joints - _f32(_HUMANOID_POSE, obs.device)) - g[1] * jointsd
    u = _add_columns(u, (4, 7), g[2] * e + g[3] * edot)
    u = _add_columns(u, (2, 5), g[4] * trunk + g[5] * trunkd + g[8] * e)
    u = _add_columns(u, (0,), g[6] * trunk + g[7] * trunkd)
    return torch.clamp(u, -1.0, 1.0)


# The time-indexed PD-tracked walking gait (expert v2):
# w = [freq, lean, bal, A_hip, A_knee, ph_knee, A_ank, ph_ank, A_arm,
#      kp_leg, kd_leg, k_v, v_ref]
_HUMANOID_WALK_PD = (
    1.8214, 0.798, 0.6853, -0.131, -1.009, 1.2864, -0.3145, -0.2525,
    0.9285, 3.0463, 0.0291, -0.1376, 1.1113,
)
_WALK_QIDX = slice(3, 15)  # actuated hinge q indices


def _walk_pd_targets(w: torch.Tensor, ph: torch.Tensor) -> torch.Tensor:
    """Phase (...) -> 12 joint-angle targets (..., 12) of the walking cycle."""
    A_h, A_k, ph_k, A_a, ph_a, A_arm = w[3], w[4], w[5], w[6], w[7], w[8]
    s_l, s_r = torch.sin(ph), torch.sin(ph + math.pi)
    zero = torch.zeros_like(ph)
    # rectified swing-leg knee flexion (knee range is [-2, 0])
    knee_l = -A_k * torch.maximum(torch.sin(ph + ph_k), zero)
    knee_r = -A_k * torch.maximum(torch.sin(ph + math.pi + ph_k), zero)
    ank_l = A_a * torch.sin(ph + ph_a)
    ank_r = A_a * torch.sin(ph + math.pi + ph_a)
    return torch.stack([zero, zero, A_h * s_l, knee_l, ank_l, A_h * s_r, knee_r, ank_r,
                        -A_arm * s_l, zero, -A_arm * s_r, zero], dim=-1)


def _walk_action(w: torch.Tensor, obs: torch.Tensor, ph: torch.Tensor, env) -> torch.Tensor:
    """PD-track the gait's targets at phase ``ph`` (B,) over the
    stand-balance blend, with a speed-servoed forward lean."""
    lean, bal = w[1], w[2]
    kp, kd = torch.abs(w[9]), torch.abs(w[10])
    k_v, v_ref = w[11], w[12]
    q = torch.cat([obs.new_zeros((obs.shape[0], 1)), obs[:, :14]], dim=-1)
    qd = obs[:, 14:]
    u_pd = kp * (_walk_pd_targets(w, ph) - q[:, _WALK_QIDX]) - kd * qd[:, _WALK_QIDX]
    gains = _f32(_HUMANOID_STAND_GAINS, obs.device)
    u = bal * humanoid_balance_policy(gains, obs, env) + u_pd
    u = _add_columns(u, (0,), -(lean + k_v * (v_ref - qd[:, 0])))
    return torch.clamp(u, -1.0, 1.0)


def humanoid_walk_action(obs: torch.Tensor, t: torch.Tensor, dt: float, env) -> torch.Tensor:
    """The time-indexed walking expert (v2): the gait's phase from the
    step counter ``t`` (B,), 2 pi freq t dt."""
    w = _f32(_HUMANOID_WALK_PD, obs.device)
    ph = 2.0 * math.pi * w[0] * t.to(torch.float32) * dt
    return _walk_action(w, obs, ph, env)


# The state-indexed walking expert (v3): the same PD-tracked cycle with the
# gait's phase matched to the observed 12-joint pose and velocity, so that
# the action is a function of the state (behaviour cloning is well posed,
# and DAgger can restart it anywhere).
# w = [freq, lean, bal, A_hip, A_knee, ph_knee, A_ank, ph_ank, A_arm,
#      kp_leg, kd_leg, k_v, v_ref, delta (phase lead), lam (velocity weight)]
_HUMANOID_WALK_PHASE = (
    1.9790, 0.8104, 0.5662, -0.1909, -0.7046, 1.3727, -0.3198, -0.2791,
    1.1607, 2.4502, 0.0245, -0.1714, 0.7430, 0.3880, 0.0010,
)


def walk_phase_from_pose(w: torch.Tensor, q_joints: torch.Tensor, qd_joints: torch.Tensor,
                         grid=None) -> torch.Tensor:
    """The gait phase (B,) whose targets best match the joints' pose and
    velocity (``match_phase``; ``grid`` from ``phase_grid`` of the walking
    targets, computed here if not given)."""
    grid = grid if grid is not None else phase_grid(_walk_pd_targets, w)
    return match_phase(grid, q_joints, qd_joints, torch.abs(w[14]))


def humanoid_walk_phase_action(w: torch.Tensor, obs: torch.Tensor, env,
                               grid=None) -> torch.Tensor:
    """The memoryless walking expert: PD-track the cycle at the
    pose-matched phase plus the lead ``delta``."""
    ph = walk_phase_from_pose(w, obs[:, 2:14], obs[:, 17:29], grid) + w[13]
    return _walk_action(w, obs, ph, env)


# The state-indexed walker gait (expert v2): the humanoid v3 design on the
# biped (antiphase hip sines, rectified swing-knee flexion, ankle push-off,
# torso-pitch balance and a speed servo through the hips), the phase matched
# to the observed pose; CEM-tuned over the differentiable engine.
# w = [freq, A_hip, A_knee, ph_knee, A_ank, ph_ank, kp, kd, k_pitch,
#      k_pitchd, k_v, v_ref, delta, lam]
_WALKER_WALK_PHASE = (
    -0.0552, 0.6620, -0.7798, -0.0775, 0.5858, -1.1868, 2.9690, -0.0028,
    5.0975, 0.2397, 0.2843, 1.4972, 1.9741, -0.0349,
)


def _walker_targets(w: torch.Tensor, ph: torch.Tensor) -> torch.Tensor:
    """Phase (...) -> 6 joint-angle targets (..., 6): left hip, knee,
    ankle, right hip, knee, ankle."""
    A_h, A_k, ph_k, A_a, ph_a = w[1], w[2], w[3], w[4], w[5]
    zero = torch.zeros_like(ph)
    knee_l = -A_k * torch.maximum(torch.sin(ph + ph_k), zero)
    knee_r = -A_k * torch.maximum(torch.sin(ph + math.pi + ph_k), zero)
    return torch.stack([A_h * torch.sin(ph), knee_l, A_a * torch.sin(ph + ph_a),
                        A_h * torch.sin(ph + math.pi), knee_r,
                        A_a * torch.sin(ph + math.pi + ph_a)], dim=-1)


def walker_walk_phase_action(w: torch.Tensor, obs: torch.Tensor, grid=None) -> torch.Tensor:
    """The memoryless walker gait, (B, 17) observations [z, pitch, 6
    joints, xd, zd, pitchd, 6 joint velocities] -> (B, 6) actions."""
    kp, kd = torch.abs(w[6]), torch.abs(w[7])
    k_p, k_pd, k_v, v_ref, delta = w[8], w[9], w[10], w[11], w[12]
    joints, jointsd = obs[:, 2:8], obs[:, 11:17]
    grid = grid if grid is not None else phase_grid(_walker_targets, w)
    ph = match_phase(grid, joints, jointsd, torch.abs(w[13])) + delta
    u = kp * (_walker_targets(w, ph) - joints) - kd * jointsd
    hip = k_p * obs[:, 1] + k_pd * obs[:, 10] - k_v * (v_ref - obs[:, 8])
    return torch.clamp(_add_columns(u, (0, 3), hip), -1.0, 1.0)


# The state-indexed cheetah gait (expert v2): per-joint sinusoidal targets
# tracked by PD, the phase matched to the observed pose, pitch feedback
# through the thighs and a speed servo; CEM-tuned over the differentiable
# engine on the default physics ("nominal") or under the torso x3 shift
# ("shift3").
_CHEETAH_PD_W_NOMINAL = (
    4.4399, 0.7766, 0.1664, 0.6158, 0.2430, 0.4822, 0.4537, -0.1115,
    0.8024, 0.2871, 2.3145, 4.0082, 3.4129, -0.2521, 0.1118, -0.8263,
    -0.0015, -0.2373, -0.4679, 2.9426, 0.2765, 2.6832, 0.5018, 0.3891,
    2.3996, 0.2229, -0.1315,
)
_CHEETAH_PD_W_SHIFT3 = (
    4.3872, 1.1501, 0.0224, 0.7340, 0.2481, 0.5644, 0.5884, -0.4845,
    0.8556, 0.2607, 1.1576, 4.1905, 3.3727, -0.1481, -0.1347, -0.9588,
    0.2874, -0.0683, -0.2184, 5.4376, 0.3975, 2.3777, 0.6126, 0.1848,
    1.8013, -0.4503, -0.1062,
)


def cheetah_pd_weights() -> tuple:
    """The gait vector of the cheetah variant in use."""
    return _CHEETAH_PD_W_SHIFT3 if cheetah_variant() == "shift3" else _CHEETAH_PD_W_NOMINAL


def _cheetah_targets(w: torch.Tensor, ph: torch.Tensor) -> torch.Tensor:
    """Phase (...) -> 6 joint-angle targets (..., 6)."""
    A, phi, mid = w[1:7], w[7:13], w[13:19]
    return mid + A * torch.sin(ph[..., None] + phi)


def cheetah_pd_action(w: torch.Tensor, obs: torch.Tensor, grid=None) -> torch.Tensor:
    """The memoryless cheetah gait, (B, 17) observations [z, pitch, 6
    joints, xd, zd, pitchd, 6 joint velocities] -> (B, 6) actions."""
    kp, kd = torch.abs(w[19]), torch.abs(w[20])
    k_p, k_pd, k_v, v_ref = w[21], w[22], w[23], w[24]
    delta, lam = w[25], torch.abs(w[26])
    joints, jointsd = obs[:, 2:8], obs[:, 11:17]
    grid = grid if grid is not None else phase_grid(_cheetah_targets, w)
    ph = match_phase(grid, joints, jointsd, lam) + delta
    u = kp * (_cheetah_targets(w, ph) - joints) - kd * jointsd
    corr = k_p * obs[:, 1] + k_pd * obs[:, 10] - k_v * (v_ref - obs[:, 8])
    return torch.clamp(_add_columns(u, (0, 3), corr), -1.0, 1.0)


def scripted_expert(env) -> Callable[[torch.Tensor], torch.Tensor]:
    """The scripted expert of ``env``: ``policy(obs (B, obs)) -> (B, act)``
    on raw observations, its constants on the env's device."""
    dev = env.device
    if env.name == "pendulum_swingup":
        p = env.default_params()
        m, r, grav = (_f32(v, dev) for v in (p.body_mass_pole, p.geom_size_pole, p.gravity))
        gain = _f32(p.torque_gain, dev)
        inertia = env.inertia(p)
        e_top = m * grav * r

        def pendulum(obs):
            cos_th, sin_th, thd = obs.unbind(-1)
            energy = 0.5 * inertia * thd ** 2 + m * grav * r * cos_th
            # the 0.3 sin_th tie-break makes the pump direction (and so the
            # logged label) a function of the state near thd = 0
            pump = 6.0 * (e_top - energy) * torch.sign(thd + 0.3 * sin_th)
            th = torch.atan2(sin_th, cos_th)
            stabilize = -8.0 * th - 1.0 * thd
            u = torch.where(torch.abs(th) < 0.5, stabilize, pump)
            return torch.clamp(u[:, None] / gain, -1.0, 1.0)

        return pendulum
    if env.name == "cartpole_balance":

        def cartpole(obs):
            x, cos_th, sin_th, xd, thd = obs.unbind(-1)
            # hand-tuned stabilizing feedback around upright
            u = 18.0 * torch.atan2(sin_th, cos_th) + 3.0 * thd + 0.9 * x + 1.6 * xd
            return torch.clamp(u[:, None], -1.0, 1.0)

        return cartpole
    if env.name == "walker_walk":
        w = _f32(_WALKER_WALK_PHASE, dev)
        grid = phase_grid(_walker_targets, w)
        return lambda obs: walker_walk_phase_action(w, obs, grid)
    if env.name == "humanoid_stand":
        gains = _f32(_HUMANOID_STAND_GAINS, dev)
        return lambda obs: humanoid_balance_policy(gains, obs, env)
    if env.name == "humanoid_walk":
        w = _f32(_HUMANOID_WALK_PHASE, dev)
        grid = phase_grid(_walk_pd_targets, w)
        return lambda obs: humanoid_walk_phase_action(w, obs, env, grid)
    if env.name == "cheetah_run":
        w = _f32(cheetah_pd_weights(), dev)
        grid = phase_grid(_cheetah_targets, w)
        return lambda obs: cheetah_pd_action(w, obs, grid)
    raise ValueError(f"no scripted expert for env {env.name!r}")


@torch.no_grad()
def collect_expert_trajectories(
    env,
    num_trajectories: int,
    generator: Optional[torch.Generator] = None,
    num_steps: int = 1000,
    env_params=None,
    noise_sigma: float = 0.25,
    reset_velocity_sigma: float = 0.0,
    init_state: Optional[EnvState] = None,
    noise: Optional[torch.Tensor] = None,
) -> TrajectorySet:
    """Roll the scripted expert over ``num_trajectories`` envs at once for
    ``num_steps`` steps, closed loop.

    With ``noise_sigma`` > 0 (DART noise) the EXECUTED action is the
    expert's plus clipped Gaussian noise, while the LOGGED action is the
    expert's clean action at the visited state; the store keeps both.
    ``reset_velocity_sigma`` > 0 adds Gaussian noise to the reset
    velocities, so that some episodes start mid-motion.

    Draws, each on the CPU from ``generator`` and then moved to the env's
    device, in this order: the resets (``env.reset``), the reset
    velocities (where ``reset_velocity_sigma`` > 0), the standard normal
    noise (num_steps, B, act). ``init_state`` (the start states, reset
    velocity included) and ``noise`` replace the draws where given.
    """
    env_params = env_params if env_params is not None else env.default_params()
    if init_state is None or noise is None:
        if generator is None:
            raise ValueError("pass a torch.Generator, or both init_state and noise")
    if init_state is None:
        init_state = env.reset(env_params, num_trajectories, generator)
        if reset_velocity_sigma > 0.0:
            kick = torch.randn(tuple(init_state.qvel.shape), generator=generator)
            init_state = EnvState(qpos=init_state.qpos,
                                  qvel=init_state.qvel + reset_velocity_sigma * kick.to(env.device),
                                  t=init_state.t)
    if noise is None:
        noise = torch.randn((num_steps, num_trajectories, env.act_size), generator=generator)
    noise = noise.to(env.device)
    policy = scripted_expert(env)
    state, outs = init_state, []
    for step in range(num_steps):
        obs = env.observe(env_params, state)
        u_clean = policy(obs)
        u_exec = torch.clamp(u_clean + noise_sigma * noise[step], -1.0, 1.0)
        state, reward = env.step(env_params, state, u_exec)
        outs.append((obs, u_clean, u_exec, reward))
    xs, us, ues, rs = (torch.stack(f, dim=1).cpu().numpy() for f in zip(*outs))
    return TrajectorySet(states=xs, actions=us, rewards=rs, executed_actions=ues)


@torch.no_grad()
def collect_dagger_trajectories(
    env,
    env_params,
    policy,
    normalizer,
    generator: Optional[torch.Generator] = None,
    num_segments: int = 64,
    segment_steps: int = 120,
    policy_steps: int = 1000,
    policy_episodes: int = 8,
    noise_sigma: float = 0.25,
    history: int = 1,
    imitator_env=None,
    imitator_env_params=None,
    state_weighting: str = "uniform",
    weight_power: float = 2.0,
    weight_floor: float = 0.05,
    policy_reset: Optional[EnvState] = None,
    picked: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> TrajectorySet:
    """DAgger's corrective expert data: roll the current ``policy`` in the
    imitator env (``policy_episodes`` envs x ``policy_steps`` steps, no
    exploration noise), pick ``num_segments`` of the visited states without
    replacement, uniformly or ``reward_weighted`` (weights (1 - clip(r, 0,
    1))^weight_power + weight_floor), and restart the scripted expert from
    exactly those (qpos, qvel) in ``env`` for ``segment_steps`` steps with
    the DART noise ``noise_sigma``, all segments as one batched rollout.
    Returns the ``TrajectorySet`` of the segments (clean actions logged,
    executed ones recorded).

    Draws, from three generators split off ``generator`` (the rollout's
    resets, the picks, the segments' standard normal noise
    (segment_steps, num_segments, act)); ``policy_reset``, ``picked``
    (flat indices into the (episode, step) states) and ``noise`` replace
    them where given.
    """
    k_roll, k_pick, k_noise = (split(generator) if generator is not None else None
                               for _ in range(3))
    ienv = imitator_env if imitator_env is not None else env
    iparams = imitator_env_params if imitator_env_params is not None else env_params
    episode = policy_rollout(ienv, iparams, policy, normalizer, num_steps=policy_steps,
                             history=history, num_envs=policy_episodes, init_state=policy_reset,
                             generator=k_roll)
    nq = episode.qpos.shape[-1]
    qpos, qvel = episode.qpos.reshape(-1, nq), episode.qvel.reshape(-1, nq)
    if picked is None:
        if state_weighting == "reward_weighted":
            # the states where the policy does worst (reward near 0), with a
            # floor that keeps some of the easy band
            r = torch.clamp(episode.rewards.reshape(-1), 0.0, 1.0).cpu()
            w = (1.0 - r) ** weight_power + weight_floor
            picked = torch.multinomial(w, num_segments, replacement=False, generator=k_pick)
        else:
            picked = torch.randperm(qpos.shape[0], generator=k_pick)[:num_segments]
    picked = picked.to(qpos.device)
    start = EnvState(qpos=qpos[picked], qvel=qvel[picked],
                     t=torch.zeros(num_segments, dtype=torch.int32, device=qpos.device))
    if noise is None:
        noise = torch.randn((segment_steps, num_segments, env.act_size), generator=k_noise)
    return collect_expert_trajectories(env, num_segments, num_steps=segment_steps,
                                       env_params=env_params, noise_sigma=noise_sigma,
                                       init_state=start, noise=noise)
