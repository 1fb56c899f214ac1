"""Planar articulated rigid-body physics, batched over envs.

Counterpart of ``gan_mpc_tpu/envs/planar.py``: a kinematic tree of rigid
links in the x-z plane with a 3-DoF floating root (x, z, pitch) and hinge
joints, Lagrangian dynamics, penalty ground contacts and semi-implicit
Euler with implicit damping. Every function takes a batch: q, qd (B, nq).

The JAX engine gets its Jacobians by autodiff (``jacfwd`` of the forward
kinematics, a ``jvp`` of the mass matrix, ``grad`` of the energies).
Here they are written out, which is exact for a planar tree:

  * Coordinate 2 + k turns body k's joint (k = 0 is the root pitch, whose
    pivot is the root origin q[:2]). A point p fixed to body i therefore
    has Jacobian column S (p - o_k) for every ancestor-or-self k of i,
    where o_k is body k's joint origin and S rotates by +90 degrees; the
    x and z columns are the identity.
  * Body angles are linear in q, so the angular Jacobian is a constant
    0/1 matrix.
  * The bias force h = Mdot qd - 1/2 d(qd^T M qd)/dq + dV/dq of the JAX
    engine equals sum_i m_i Jc_i^T (dJc_i/dt qd) + dV/dq (the Coriolis
    identity for M = sum J^T m J). With qdd = 0 the term dJc/dt qd is the
    point's centripetal acceleration: each rigid segment R(a) v of the
    chain contributes -(da/dt)^2 R(a) v.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass
class PlanarModel:
    """A planar kinematic tree (see ``gan_mpc_tpu/envs/planar.py``).

    Body 0 is the root; body i > 0 hangs from ``parent[i]`` through a
    hinge at ``joint_anchor[i]`` (parent frame) with angle q[2 + i].
    Tensors are float32 on the env's device.
    """

    parent: Tuple[int, ...]
    joint_anchor: torch.Tensor  # (nb, 2)
    com_offset: torch.Tensor  # (nb, 2)
    mass: torch.Tensor  # (nb,)
    inertia: torch.Tensor  # (nb,)
    joint_stiffness: torch.Tensor  # (nb,)
    joint_damping: torch.Tensor  # (nb,)
    joint_ref: torch.Tensor  # (nb,)
    joint_range: torch.Tensor  # (nb, 2)
    gear: torch.Tensor  # (nb,)
    contact_body: Tuple[int, ...]
    contact_offset: torch.Tensor  # (nc, 2)
    gravity: float = 9.81
    ground_kp: float = 4000.0
    ground_kd: float = 100.0
    friction_mu: float = 1.0
    friction_vslip: float = 0.1
    limit_kp: float = 300.0

    def __post_init__(self):
        nb = len(self.parent)
        anc = np.zeros((nb, nb), np.float32)  # anc[i, k]: k is i or above i
        for i in range(nb):
            k = i
            while k >= 0:
                anc[i, k] = 1.0
                k = self.parent[k]
        dev = self.mass.device
        self.ancestors = torch.tensor(anc, device=dev)
        self.contact_ancestors = self.ancestors[list(self.contact_body)]
        # angular Jacobian: body angle = sum of its chain's joint coords
        ja = np.zeros((nb, nb + 2), np.float32)
        ja[:, 2:] = anc
        self.angle_jac = torch.tensor(ja, device=dev)
        gears = self.gear[1:].cpu().numpy()
        act_idx = np.clip(np.cumsum(gears > 0) - 1, 0, None)
        self.actuator_index = torch.tensor(act_idx, device=dev)
        self.actuated = torch.tensor(gears > 0, device=dev)


def _rotate(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(a) v for angles a (...) and vectors v (..., 2)."""
    c, s = torch.cos(a), torch.sin(a)
    return torch.stack(
        [c * v[..., 0] - s * v[..., 1], s * v[..., 0] + c * v[..., 1]], dim=-1
    )


def _perp(v: torch.Tensor) -> torch.Tensor:
    """S v: v turned by +90 degrees."""
    return torch.stack([-v[..., 1], v[..., 0]], dim=-1)


def forward_kinematics(model: PlanarModel, q: torch.Tensor):
    """World angle (B, nb), joint origin (B, nb, 2) and COM (B, nb, 2)."""
    angles = [q[:, 2]]
    origins = [q[:, :2]]
    for i in range(1, len(model.parent)):
        p = model.parent[i]
        angles.append(angles[p] + q[:, 2 + i])
        origins.append(origins[p] + _rotate(angles[p], model.joint_anchor[i]))
    angles = torch.stack(angles, dim=1)
    origins = torch.stack(origins, dim=1)
    coms = origins + _rotate(angles, model.com_offset)
    return angles, origins, coms


def point_jacobian(points, ancestors, origins):
    """Jacobian (B, P, 2, nq) of points (B, P, 2) fixed to bodies whose
    ancestor-or-self rows are ``ancestors`` (P, nb)."""
    B, P, _ = points.shape
    lever = _perp(points[:, :, None, :] - origins[:, None, :, :])  # (B,P,nb,2)
    ang = (ancestors[None, :, :, None] * lever).transpose(-1, -2)  # (B,P,2,nb)
    lin = torch.eye(2, dtype=points.dtype, device=points.device).expand(B, P, 2, 2)
    return torch.cat([lin, ang], dim=-1)


def contact_points(model: PlanarModel, angles, origins) -> torch.Tensor:
    b = list(model.contact_body)
    return origins[:, b] + _rotate(angles[:, b], model.contact_offset)


def mass_matrix(model: PlanarModel, Jc: torch.Tensor) -> torch.Tensor:
    """M = Jc^T diag(m) Jc + Ja^T diag(I) Ja from the COM Jacobians."""
    M = torch.einsum("bpxi,p,bpxj->bij", Jc, model.mass, Jc)
    Ja = model.angle_jac
    return M + torch.einsum("pi,p,pj->ij", Ja, model.inertia, Ja)


def bias_forces(model: PlanarModel, q, qd, angles, origins, coms, Jc):
    """Coriolis/centrifugal + gravity: sum_i m_i Jc_i^T (dJc_i/dt qd)
    + dV/dq."""
    omega = qd @ model.angle_jac.T  # (B, nb) absolute angular velocities
    par = list(model.parent[1:])
    # segment o_k - o_parent(k) turns at the parent's rate
    seg = (origins[:, 1:] - origins[:, par]) * (omega[:, par] ** 2)[..., None]
    seg = torch.cat([torch.zeros_like(seg[:, :1]), seg], dim=1)  # (B, nb, 2)
    acc = -torch.einsum("ik,bkx->bix", model.ancestors, seg)
    acc = acc - (omega**2)[..., None] * (coms - origins)  # (B, nb, 2)
    h = torch.einsum("bpxj,p,bpx->bj", Jc, model.mass, acc)
    return h + model.gravity * torch.einsum("bpj,p->bj", Jc[:, :, 1, :], model.mass)


def joint_forces(model: PlanarModel, q, qd) -> torch.Tensor:
    """Passive hinge forces: stiffness toward rest, damping, soft limits."""
    hinge_q, hinge_qd = q[:, 3:], qd[:, 3:]
    lo, hi = model.joint_range[1:, 0], model.joint_range[1:, 1]
    tau = -model.joint_stiffness[1:] * (hinge_q - model.joint_ref[1:])
    tau = tau - model.joint_damping[1:] * hinge_qd
    tau = tau - model.limit_kp * (
        torch.clamp(hinge_q - hi, min=0.0) + torch.clamp(hinge_q - lo, max=0.0)
    )
    return torch.cat([torch.zeros_like(q[:, :3]), tau], dim=1)


def contact_forces(model: PlanarModel, qd, pts, Jp) -> torch.Tensor:
    """Penalty ground contact mapped to joint space (J^T f)."""
    vel = torch.einsum("bcxi,bi->bcx", Jp, qd)
    depth = -pts[..., 1]
    fn = torch.where(
        depth > 0.0,
        model.ground_kp * depth - model.ground_kd * torch.clamp(vel[..., 1], max=0.0),
        0.0,
    )
    fn = torch.clamp(fn, min=0.0)
    ft = -model.friction_mu * fn * torch.tanh(vel[..., 0] / model.friction_vslip)
    f = torch.stack([ft, fn], dim=-1)
    return torch.einsum("bcxi,bcx->bi", Jp, f)


def actuation(model: PlanarModel, u: torch.Tensor) -> torch.Tensor:
    """Bounded controls (B, m) -> joint torques (B, nq); u has one entry
    per actuated hinge (gear > 0), in body order."""
    gears = model.gear[1:]
    full = torch.where(model.actuated, gears * u[:, model.actuator_index], 0.0)
    return torch.cat([torch.zeros_like(u[:, :3]), full], dim=1)


def damping_matrix(model: PlanarModel, pts, Jp) -> torch.Tensor:
    """D with tau_damp ~= -D qd: joint damping plus the normal contact
    damper of active contacts (folded into the implicit solve)."""
    B, _, _, nq = Jp.shape
    diag = torch.cat([model.joint_damping.new_zeros(3), model.joint_damping[1:]])
    active = (pts[..., 1] < 0.0).to(pts.dtype) * model.ground_kd
    Jz = Jp[:, :, 1, :]
    return torch.diag(diag) + torch.einsum("bc,bci,bcj->bij", active, Jz, Jz)


def step(model: PlanarModel, q, qd, u, dt: float, substeps: int = 2):
    """One control step (semi-implicit Euler with implicit damping)."""
    h = dt / substeps
    tau_a = actuation(model, u)
    eye = 1e-6 * torch.eye(q.shape[1], dtype=q.dtype, device=q.device)
    for _ in range(substeps):
        angles, origins, coms = forward_kinematics(model, q)
        Jc = point_jacobian(coms, model.ancestors, origins)
        pts = contact_points(model, angles, origins)
        Jp = point_jacobian(pts, model.contact_ancestors, origins)
        M = mass_matrix(model, Jc)
        rhs = (
            tau_a
            - bias_forces(model, q, qd, angles, origins, coms, Jc)
            + joint_forces(model, q, qd)
            + contact_forces(model, qd, pts, Jp)
        )
        # (M + h D)(qd_next - qd) = h rhs: the damper acts on qd_next
        A = M + h * damping_matrix(model, pts, Jp) + eye
        qd = qd + h * torch.linalg.solve(A, rhs)
        q = q + h * qd
    return q, qd
