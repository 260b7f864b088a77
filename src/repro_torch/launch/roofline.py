"""Roofline analysis of the dry run's per-device counts (the port of
``repro.launch.roofline``).

Three terms, all in seconds, per (arch x shape x mesh), against a chip
record (:class:`Chip`):

    compute    = flops_per_device / chip.peak_flops
    memory     = bytes_per_device / chip.hbm_bw
    collective = collective_bytes_per_device / chip.link_bw

The reference reads them from XLA: ``cost_analysis()`` of the compiled,
SPMD-partitioned executable for the FLOPs and bytes, and the collectives of
its post-optimization HLO text. The port has no compiler. :class:`StepCounter`
counts what one rank's eager PyTorch step dispatches, *below* DTensor: it
lets DTensor run each op on the rank's local shards and counts those local
ops, so that a column-sharded product counts its shard's FLOPs (a plain
``FlopCounterMode`` over a DTensor step counts the global FLOPs):

* FLOPs: ``torch.utils.flop_counter``'s formulas of each local op (matrix
  products, convolutions, attention); elementwise ops count none;
* bytes: each local op's tensor inputs and outputs, views and collectives
  excluded: an unfused upper bound, as the reference's per-op HLO bytes;
* collective bytes: the result bytes of every all-gather, all-reduce,
  reduce-scatter and all-to-all the rank issues (DTensor's functional
  collectives), the reference's convention (``collective_bytes``);
* peak bytes: the live bytes of the local tensors the step creates, above
  its arguments (:meth:`StepCounter.memory`).

These numbers come from torch's op counts, not from a compiler: nothing is
fused, and elementwise FLOPs are not counted. They are not comparable with
the reference's, which XLA computed for its own program.

The reference's chip constants (``PEAK_FLOPS``, ``HBM_BW``, ``ICI_BW``) stay
as they are: ``dcsim.topology`` specs the simulated accelerator fleet of the
``llm`` workload relative to them. They are simulator data, the same in both
packages, and say nothing about the card this package runs on; the analyzer
defaults to the card's own record, :data:`H100`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Any, Dict, Iterator, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..units import BYTES_PER_GB

# -- the reference's chip constants (simulator data, see above) ---------------
PEAK_FLOPS = 197e12     # bf16 per chip  # lint: unit(FLOP/s)
HBM_BW = 819e9          # per chip  # lint: unit(B/s)
ICI_BW = 50e9           # per link  # lint: unit(B/s)


@dataclasses.dataclass(frozen=True)
class Chip:
    """What bounds one device: dense bf16 FLOP/s, memory B/s, one link's B/s."""

    name: str
    peak_flops: float  # lint: unit(FLOP/s)
    hbm_bw: float  # lint: unit(B/s)
    link_bw: float  # lint: unit(B/s)


# the reference's constants as a record: the parity tests pass it
REFERENCE_CHIP = Chip("reference (simulator data)", PEAK_FLOPS, HBM_BW, ICI_BW)
# NVIDIA H100 SXM 80GB HBM3 at its 700 W power limit, NVIDIA's data sheet:
# 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, NVLink 900 GB/s to the other cards
# of the host, 450 GB/s each way
H100 = Chip("NVIDIA H100 80GB HBM3, 700 W", 989e12, 3.35e12, 450e9)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d")


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float          # upper bound: per-op bytes (unfused)
    memory_lb_s: float       # lower bound: each live byte touched once
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float
    memory_per_device_gb: float
    note: str = ""

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def model_flops(cfg, shape, active_params: int) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N·D for inference forward."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active_params * tokens


def _leaves_with_path(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, c in enumerate(tree):
            yield from _leaves_with_path(c, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def active_param_count(params_tree) -> Tuple[int, int]:
    """(total, expert) param counts of the port's tree (tensors, meta tensors
    or anything with ``.shape``): expert leaves are those whose path holds
    ``experts``; the caller discounts them by k/E."""
    total = 0
    expert = 0
    for path, leaf in _leaves_with_path(params_tree):
        n = math.prod(leaf.shape)
        total += n
        if "experts" in path:
            expert += n
    return total, expert


def probe_extrapolate(costs_p: Tuple[float, float, float],
                      costs_2p: Tuple[float, float, float],
                      period: int, num_layers: int) -> Tuple[float, float, float]:
    """Linear-in-depth extrapolation: cost(L) = a + b·L from two probes at
    L=period and L=2·period."""
    out = []
    for c1, c2 in zip(costs_p, costs_2p):
        b = (c2 - c1) / period
        a = c1 - b * period
        out.append(max(a + b * num_layers, 0.0))
    return tuple(out)


def analyze(
    *,
    arch: str,
    shape_name: str,
    mesh_name: str,
    chips: int,
    cfg,
    shape,
    params_tree,
    flops: float,
    byts: float,
    coll: float,
    memory: Dict[str, int] | None = None,
    chip: Chip = H100,
) -> RooflineReport:
    """The three terms against ``chip``, MODEL_FLOPS and the useful ratio.
    ``memory`` holds the step's ``argument_bytes_per_device``,
    ``temp_bytes_per_device`` and ``output_bytes_per_device`` (the dry run's
    :meth:`StepCounter.memory`), where the reference reads the compiled
    executable's ``memory_analysis()``."""
    compute_s = flops / chip.peak_flops
    memory_s = byts / chip.hbm_bw
    collective_s = coll / chip.link_bw
    mem_lb, mem_gb = float("nan"), float("nan")
    if memory is not None:
        arg, temp = memory["argument_bytes_per_device"], memory["temp_bytes_per_device"]
        mem_lb = (arg + temp + memory["output_bytes_per_device"]) / chip.hbm_bw
        mem_gb = (arg + temp) / BYTES_PER_GB
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)

    total_p, expert_p = active_param_count(params_tree)
    if cfg.num_experts:
        active = total_p - expert_p * (1.0 - cfg.num_experts_per_tok / cfg.num_experts)
    else:
        active = total_p
    mf = model_flops(cfg, shape, int(active))
    useful = mf / (flops * chips) if flops else 0.0

    return RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        flops_per_device=flops, bytes_per_device=byts,
        collective_bytes_per_device=float(coll),
        compute_s=compute_s, memory_s=memory_s, memory_lb_s=mem_lb,
        collective_s=collective_s,
        bottleneck=bottleneck, model_flops=mf, useful_ratio=float(useful),
        memory_per_device_gb=float(mem_gb), note=f"chip: {chip.name}; torch op counts",
    )


# ---------------------------------------------------------------------------
# per-device counting below DTensor
# ---------------------------------------------------------------------------

def _tensors(tree) -> Iterator[torch.Tensor]:
    from torch.utils._pytree import tree_leaves

    return (t for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def local_bytes(tree) -> int:
    """This rank's bytes of every tensor in ``tree`` (a DTensor's local shard)."""
    return sum(_nbytes(_local(t)) for t in _tensors(tree))


def _collective_kind(func) -> str | None:
    ns, _, name = func._schema.name.partition("::")
    if ns not in _COLLECTIVE_NAMESPACES:
        return None
    flat = name.replace("_", "")
    for kind in COLLECTIVES:
        if kind.replace("-", "") in flat:
            return kind
    return None


class StepCounter(TorchDispatchMode):
    """Counts one rank's local work in a step (see the module docstring).

    Enter it after the step's arguments exist (inside the same
    ``FakeTensorMode``, when the step runs on fake tensors), with those
    arguments: their storages are not the step's own, so that what the step
    writes into them in place is not counted as new memory. An op with a
    DTensor argument is handed to DTensor (``NotImplemented``), which runs it
    on the local shards; those local ops come back through this mode and are
    counted. DTensor's sharding propagation runs each new op once on
    global-shape stand-ins: :func:`count_step` pauses the count there.
    """

    def __init__(self, arguments: Any = ()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collective = {k: 0 for k in COLLECTIVES}
        self.paused = 0
        self._arg_storages = {_local(t).untyped_storage()._cdata for t in _tensors(arguments)}
        self._live_storages: Dict[int, int] = {}
        self.live = 0
        self.peak = 0

    @property
    def collective_bytes(self) -> int:
        return sum(self.collective.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not self.paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        kind = _collective_kind(func)
        if kind is not None:
            if "wait" not in func._schema.name:
                self.collective[kind] += sum(_nbytes(t) for t in _tensors(out))
            return
        if func._schema.name.startswith("prim::"):
            return
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            self.flops += int(fn(*args, **kwargs, out_val=out))
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs, out)))
        for t in _tensors(out):
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._arg_storages or key in self._live_storages:
            return
        n = st.nbytes()
        self._live_storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._live_storages.pop(key, 0)

    def memory(self, arguments: Any, outputs: Any) -> Dict[str, int]:
        """The reference's ``memory_analysis()`` keys, per device:
        ``argument_bytes_per_device`` (the local shard bytes of ``arguments``),
        ``temp_bytes_per_device`` (the step's peak of live bytes above its
        arguments), ``output_bytes_per_device`` (the local bytes of what it
        returns) and ``alias_bytes_per_device`` (the part of those that are
        its arguments' own storage, written in place)."""
        seen, out_bytes, alias = set(), 0, 0
        for t in _tensors(outputs):
            local = _local(t)
            st = local.untyped_storage()._cdata
            if st in seen:
                continue
            seen.add(st)
            out_bytes += _nbytes(local)
            if st in self._arg_storages:
                alias += _nbytes(local)
        return {"argument_bytes_per_device": local_bytes(arguments),
                "temp_bytes_per_device": self.peak,
                "output_bytes_per_device": out_bytes,
                "alias_bytes_per_device": alias}


# DTensor's metadata work, which runs outside the fake mode (see count_step)
_METADATA = (("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
              ("propagate_op_sharding_non_cached", "_propagate_tensor_meta_non_cached")),
             ("torch.distributed.tensor.placement_types", "_StridedShard",
              ("local_shard_size_and_offset",)))


@contextlib.contextmanager
def count_step(arguments: Any = ()):
    """A :class:`StepCounter` over the work done inside.

    DTensor's metadata work is left out of the count and runs outside the
    fake mode: its sharding propagation (global-shape stand-ins of each new
    op) and its sizing of strided shards (a shard's indices, as a small
    tensor whose values it reads), which a fake tensor cannot serve."""
    import importlib

    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor

    counter = StepCounter(arguments)

    def outside(fn):
        def run(*args, **kwargs):
            counter.paused += 1
            try:
                with unset_fake_temporarily():
                    return fn(*args, **kwargs)
            finally:
                counter.paused -= 1
        return run

    classes = [(getattr(importlib.import_module(module), cls, None), names)
               for module, cls, names in _METADATA]
    # what this torch has of them (the names have moved between releases)
    patched = [(cls, name) for cls, names in classes for name in names
               if cls is not None and hasattr(cls, name)]
    originals = [getattr(cls, name) for cls, name in patched]
    # the cached entry point, an instance attribute bound to the uncached method
    prop = DTensor._op_dispatcher.sharding_propagator
    cached = prop.propagate_op_sharding
    prop.propagate_op_sharding = outside(cached)
    for (cls, name), fn in zip(patched, originals):
        setattr(cls, name, outside(fn))
    try:
        with counter:
            yield counter
    finally:
        prop.propagate_op_sharding = cached
        for (cls, name), fn in zip(patched, originals):
            setattr(cls, name, fn)
