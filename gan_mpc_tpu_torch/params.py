"""Weights for the port, three ways.

``from_jax_params`` loads the JAX policy's parameter tree (nested dicts
of numpy arrays, as ``jax.device_get`` returns them) into an
``MPCPolicy``: Dense stacks in ``Dense_i`` index order with (in, out)
kernels, the expert's ``OptimizedLSTMCell`` gate kernels and biases (or
its "mlp" arch's Dense trunk) and its prediction heads, the critic's
scanned cell and head, and the dynamics of each kind: a residual MLP's
stack, an LSTM dynamics net's cell and head, an ensemble's stacked
leaves (a leading member axis E on every kernel and bias) member by
member. ``dynamics_from_jax_params``,
``expert_from_jax_params`` and ``critic_from_jax_params`` load one
component alone; ``expert_to_jax_params`` gives an expert's tree back, as
an expert run saves it.

``load_msgpack`` reads a ``params.msgpack`` file as the JAX runners save it
(``flax.serialization.msgpack_serialize``) into that nested dict, with a
decoder of its own: neither flax nor a ``msgpack`` package is needed.
The other way, ``to_jax_params`` gives a policy's tree under the JAX
names and ``save_msgpack`` writes it as flax does: the same bytes as
``flax.serialization.to_bytes`` of that tree (map keys sorted, as flax's
tree copy leaves them; arrays as ext type 1). The port's ``Dense`` keeps
flax's (in, out) kernel, so no layout changes on the way.

``init_flax_like`` draws fresh weights from a ``torch.Generator`` with
flax's default initializers: lecun_normal (truncated normal, std
sqrt(1/fan_in)/0.8796) for Dense and LSTM input kernels, orthogonal for
the LSTM recurrent kernels, zero biases. It serves the card, which has
no JAX. The numbers differ from flax's (other generator), the
distribution is the same.
"""

from __future__ import annotations

import math
import struct
from typing import Mapping, Tuple

import numpy as np
import torch
from torch import nn

from gan_mpc_tpu_torch.models.dynamics import LSTMDynamicsNet
from gan_mpc_tpu_torch.models.expert import GATES, OptimizedLSTMCell
from gan_mpc_tpu_torch.ops.fused_mlp import Dense

# stddev of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _copy(dst: torch.Tensor, src) -> None:
    src = torch.tensor(np.asarray(src, np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(src.shape)} does not fit {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src)


def _load_dense_stack(layers, tree: Mapping) -> None:
    names = sorted(tree, key=lambda s: int(s.rsplit("_", 1)[1]))
    if len(names) != len(layers):
        raise ValueError(f"{len(names)} Dense layers for a stack of {len(layers)}")
    for d, name in zip(layers, names):
        _copy(d.kernel, tree[name]["kernel"])
        _copy(d.bias, tree[name]["bias"])


def _load_lstm_cell(cell: OptimizedLSTMCell, tree: Mapping) -> None:
    for g in GATES:
        _copy(getattr(cell, f"i{g}"), tree[f"i{g}"]["kernel"])
        _copy(getattr(cell, f"h{g}"), tree[f"h{g}"]["kernel"])
        _copy(getattr(cell, f"h{g}_bias"), tree[f"h{g}"]["bias"])


def from_jax_params(tree: Mapping, policy: nn.Module) -> nn.Module:
    """Load ``{"mpc_weights", "cost_params", "dynamics_params",
    "expert_params"[, "critic_params"]}`` into ``policy`` (in place; also
    returned). ``critic_params`` goes into the policy's critic; a policy
    without one (the serving path's) does not read it."""
    cost = policy.cost_model
    weights = np.asarray(tree["mpc_weights"], np.float32)
    cost.weights = nn.Parameter(
        torch.tensor(weights, device=cost.weights.device),
        requires_grad=cost.weights.requires_grad,
    )
    _load_dense_stack(cost.net.layers, tree["cost_params"]["params"])
    dynamics_from_jax_params(tree["dynamics_params"], policy.dynamics_model)
    expert_from_jax_params(tree["expert_params"], policy.expert_model)
    if "critic_params" in tree and policy.critic_model is not None:
        critic_from_jax_params(tree["critic_params"], policy.critic_model)
    return policy


def expert_from_jax_params(tree: Mapping, expert: nn.Module) -> nn.Module:
    """Load a JAX ``expert_params`` tree (``{"params": {"_LSTMCell_0":
    ...}}`` or ``{"params": {"_MLPCell_0": ...}}``) into an
    ``ExpertPredictor`` of that arch (in place; also returned)."""
    if expert.arch == "lstm":
        cell = tree["params"]["_LSTMCell_0"]
        _load_lstm_cell(expert.cell.lstm, cell["OptimizedLSTMCell_0"])
    else:
        cell = tree["params"]["_MLPCell_0"]
        _load_dense_stack([expert.cell.trunk], {"Dense_0": cell["Dense_0"]})
    _load_dense_stack(expert.cell.heads.layers, cell["_PredictionHeads_0"])
    return expert


def critic_from_jax_params(tree: Mapping, critic: nn.Module) -> nn.Module:
    """Load a JAX ``critic_params`` tree (``{"params":
    {"ScanOptimizedLSTMCell_0": ..., "Dense_i": ...}}``) into a
    ``SequenceCritic`` (in place; also returned)."""
    params = tree["params"]
    _load_lstm_cell(critic.lstm, params["ScanOptimizedLSTMCell_0"])
    _load_dense_stack(critic.head, {k: v for k, v in params.items() if k.startswith("Dense_")})
    return critic


def dynamics_from_jax_params(tree: Mapping, dynamics: nn.Module) -> nn.Module:
    """Load a JAX ``dynamics_params`` tree into ``dynamics`` (in place; also
    returned): ``{"params": {"Dense_i": ...}}`` into a ``LearnedDynamics``
    with a residual MLP net, or into an ``EnsembleDynamics`` from stacked
    leaves (member e takes ``[e]`` of each); ``{"params":
    {"OptimizedLSTMCell_0": ..., "Dense_i": ...}}`` into one with an LSTM
    net."""
    params = tree["params"]
    members = getattr(dynamics, "members", None)
    if members is not None:
        lead = {np.asarray(leaf).shape[0] for layer in params.values() for leaf in layer.values()}
        if lead != {len(members)}:
            raise ValueError(f"stacked dynamics leaves of {sorted(lead)} members for an "
                             f"ensemble of {len(members)}")
        for e, member in enumerate(members):
            dynamics_from_jax_params({"params": {
                name: {k: np.asarray(v)[e] for k, v in layer.items()}
                for name, layer in params.items()}}, member)
        return dynamics
    net = dynamics.net
    if isinstance(net, LSTMDynamicsNet):
        _load_lstm_cell(net.cell, params["OptimizedLSTMCell_0"])
        params = {k: v for k, v in params.items() if k.startswith("Dense_")}
    _load_dense_stack(net.layers, params)
    return dynamics


def dynamics_to_jax_params(dynamics: nn.Module) -> dict:
    """The inverse of ``dynamics_from_jax_params``."""
    members = getattr(dynamics, "members", None)
    if members is not None:
        trees = [dynamics_to_jax_params(m)["params"] for m in members]
        return {"params": {name: {k: np.stack([t[name][k] for t in trees])
                                  for k in layer} for name, layer in trees[0].items()}}
    net = dynamics.net
    tree = _dense_stack_tree(net.layers)
    if isinstance(net, LSTMDynamicsNet):
        tree["OptimizedLSTMCell_0"] = _lstm_cell_tree(net.cell)
    return {"params": tree}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32, copy=True)


def _dense_stack_tree(layers) -> dict:
    return {f"Dense_{i}": {"kernel": _np(d.kernel), "bias": _np(d.bias)}
            for i, d in enumerate(layers)}


def _lstm_cell_tree(cell: OptimizedLSTMCell) -> dict:
    tree = {}
    for g in GATES:
        tree[f"i{g}"] = {"kernel": _np(getattr(cell, f"i{g}"))}
        tree[f"h{g}"] = {"kernel": _np(getattr(cell, f"h{g}")),
                         "bias": _np(getattr(cell, f"h{g}_bias"))}
    return tree


def expert_to_jax_params(expert: nn.Module) -> dict:
    """The inverse of ``expert_from_jax_params``: the flax tree of an
    ``ExpertPredictor`` of either arch."""
    cell = expert.cell
    if expert.arch == "lstm":
        return {"params": {"_LSTMCell_0": {
            "OptimizedLSTMCell_0": _lstm_cell_tree(cell.lstm),
            "_PredictionHeads_0": _dense_stack_tree(cell.heads.layers),
        }}}
    return {"params": {"_MLPCell_0": {
        **_dense_stack_tree([cell.trunk]),
        "_PredictionHeads_0": _dense_stack_tree(cell.heads.layers),
    }}}


def to_jax_params(policy: nn.Module) -> dict:
    """The inverse of ``from_jax_params``: ``policy``'s weights as the JAX
    ``build_policy`` tree (``mpc_weights``, ``cost_params``,
    ``dynamics_params``, ``expert_params``, and ``critic_params`` where the
    policy has a critic), numpy float32 arrays on the host."""
    cost = policy.cost_model
    tree = {
        "mpc_weights": _np(cost.weights),
        "cost_params": {"params": _dense_stack_tree(cost.net.layers)},
        "dynamics_params": dynamics_to_jax_params(policy.dynamics_model),
        "expert_params": expert_to_jax_params(policy.expert_model),
    }
    critic = getattr(policy, "critic_model", None)
    if critic is not None:
        tree["critic_params"] = {"params": {
            "ScanOptimizedLSTMCell_0": _lstm_cell_tree(critic.lstm),
            **_dense_stack_tree(critic.head),
        }}
    return tree


class _Msgpack:
    """A reader of the msgpack types flax writes: nil, booleans, ints,
    floats, strings, bins, arrays, maps, and the ext types 1 (ndarray) and
    3 (numpy scalar), whose payload is itself msgpack: (shape, dtype name,
    bytes)."""

    # first byte -> (struct format of the value or of the length that follows)
    _NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    _BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
    _STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
    _ARRAY = {0xDC: ">H", 0xDD: ">I"}
    _MAP = {0xDE: ">H", 0xDF: ">I"}
    _EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
    _FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside a value")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def number(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.number(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        if b in self._NUMBERS:
            return self.number(self._NUMBERS[b])
        if b in self._BIN:
            return bytes(self.take(self.number(self._BIN[b])))
        if b in self._STR:
            return str(self.take(self.number(self._STR[b])), "utf-8")
        if b in self._ARRAY:
            return [self.value() for _ in range(self.number(self._ARRAY[b]))]
        if b in self._MAP:
            return self.map(self.number(self._MAP[b]))
        if b in self._EXT or b in self._FIXEXT:
            size = self._FIXEXT[b] if b in self._FIXEXT else self.number(self._EXT[b])
            return self.ext(self.number(">b"), self.take(size))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not read here")

    def map(self, n: int) -> dict:
        return {self.value(): self.value() for _ in range(n)}

    @staticmethod
    def ext(code: int, payload: memoryview):
        if code not in (1, 3):
            raise ValueError(f"msgpack ext type {code} is not read here (1: ndarray, "
                             "3: numpy scalar)")
        shape, dtype, buffer = _Msgpack(payload).value()
        arr = np.frombuffer(buffer, dtype=np.dtype(dtype)).reshape(shape).copy()
        return arr if code == 1 else arr[()]


def load_msgpack(path) -> dict:
    """The parameter tree of a ``params.msgpack`` file: nested dicts with
    string keys and numpy arrays at the leaves, as
    ``flax.serialization.msgpack_restore`` returns them, ready for
    ``from_jax_params`` and ``dynamics_from_jax_params``."""
    with open(path, "rb") as f:
        reader = _Msgpack(f.read())
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{path}: {len(reader.data) - reader.pos} bytes after the tree")
    return tree


def _header(small: int, n: int, fix_max: int, wide: Tuple[int, int, int]) -> bytes:
    """A msgpack length header: ``small | n`` up to ``fix_max``, else the
    first of the 8-, 16- and 32-bit forms ``wide`` (0 where a form does
    not exist) that holds ``n``."""
    if n <= fix_max:
        return bytes([small | n])
    for code, fmt, top in zip(wide, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} is too large")


def _pack_int(v: int) -> bytes:
    if -32 <= v <= 127:
        return struct.pack(">b" if v < 0 else ">B", v)
    if v > 0:
        forms = ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF), (0xCE, ">I", 0xFFFFFFFF),
                 (0xCF, ">Q", 2 ** 64 - 1))
        for code, fmt, top in forms:
            if v <= top:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        forms = ((0xD0, ">b", 2 ** 7), (0xD1, ">h", 2 ** 15), (0xD2, ">i", 2 ** 31),
                 (0xD3, ">q", 2 ** 63))
        for code, fmt, top in forms:
            if v >= -top:
                return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit msgpack")


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fixed[n]]) if n in fixed else _header(0, n, -1, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + payload


def _pack(obj) -> bytes:
    """msgpack of ``obj`` as flax writes a parameter tree (``msgpack.packb``
    with flax's ext hook): maps with their keys sorted, arrays as ext type
    1 and numpy scalars as ext type 3 over (shape, dtype name, C bytes)."""
    if obj is None or isinstance(obj, bool):
        return bytes([{None: 0xC0, False: 0xC2, True: 0xC3}[obj]])
    if isinstance(obj, int):
        return _pack_int(obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        return _header(0xA0, len(raw), 31, (0xD9, 0xDA, 0xDB)) + raw
    if isinstance(obj, bytes):
        return _header(0, len(obj), -1, (0xC4, 0xC5, 0xC6)) + obj
    if isinstance(obj, (list, tuple)):
        return _header(0x90, len(obj), 15, (0, 0xDC, 0xDD)) + b"".join(map(_pack, obj))
    if isinstance(obj, dict):
        return _header(0x80, len(obj), 15, (0, 0xDE, 0xDF)) + b"".join(
            _pack(k) + _pack(obj[k]) for k in sorted(obj))
    if isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes are not written")
        payload = _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")])
        return _pack_ext(1 if isinstance(obj, np.ndarray) else 3, payload)
    raise TypeError(f"{type(obj).__name__} is not written to msgpack")


def save_msgpack(tree: Mapping, path) -> None:
    """Write ``tree`` (nested dicts of numpy arrays, e.g. ``to_jax_params``)
    to ``path`` as ``flax.serialization.to_bytes`` would; JAX's
    ``io.load_params`` and ``load_msgpack`` read it back."""
    with open(path, "wb") as f:
        f.write(_pack(dict(tree)))


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's lecun_normal for an (in, out) kernel."""
    std = math.sqrt(1.0 / w.shape[0]) / _TRUNC_STD
    with torch.no_grad():
        t = torch.empty(w.shape)
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.copy_(t * std)
    return w


def orthogonal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        t = torch.empty(w.shape)
        nn.init.orthogonal_(t, generator=generator)
        w.copy_(t)
    return w


def init_flax_like(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fresh flax-default weights for every Dense and LSTM cell in
    ``module`` (in place; also returned). MPC weights are left as set."""
    for sub in module.modules():
        if isinstance(sub, Dense):
            lecun_normal_(sub.kernel, generator)
            with torch.no_grad():
                sub.bias.zero_()
        elif isinstance(sub, OptimizedLSTMCell):
            for g in GATES:
                lecun_normal_(getattr(sub, f"i{g}"), generator)
                orthogonal_(getattr(sub, f"h{g}"), generator)
                with torch.no_grad():
                    getattr(sub, f"h{g}_bias").zero_()
    return module
