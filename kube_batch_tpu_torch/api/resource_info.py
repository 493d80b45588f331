"""The resource vector (reference pkg/scheduler/api/resource_info.go:30-339).

``Resource`` keeps milli-CPU and memory as dedicated floats plus a dict of
scalar resources (GPUs, TPUs, extended resources) in milli-units, exactly
like the reference. Epsilon thresholds match resource_info.go:70-72:
quantities below (10 mCPU, 10 MiB, 10 milli-scalar) are treated as zero.

This struct is also the contract for the solve path: ``to_vector`` /
``from_vector`` lay a Resource out as one row of the dense float32
task x resource and node x resource tensors built by
kube_batch_tpu_torch.ops.encode (SURVEY.md section 7 step 1).

Nil-map parity (round-2 decision, tested in tests/test_resource_info.py):
Go distinguishes a nil ScalarResources map from an empty one, and that
distinction *does* gate policy — ``Less`` returns False when both maps are
nil even if cpu/memory are strictly less (resource_info.go:234-239), and
``Less`` guards preempt's validateVictims (preempt.go:268), reclaim
(reclaim.go:156) and enqueue's overcommit brake (enqueue.go:88). In Go a
scalar map is nil iff no scalar was ever added (NewResource/AddScalar
initialize lazily), so an empty Python dict maps exactly onto a nil Go
map: ``{} == nil``. less/less_equal/sub below implement the Go branches
under that identification, bit-for-bit.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional, Sequence

# reference resource_info.go:44
GPU_RESOURCE_NAME = "nvidia.com/gpu"
# TPU-native addition: Google TPU extended resource, first-class scalar slot.
TPU_RESOURCE_NAME = "google.com/tpu"

# Epsilons (reference resource_info.go:70-72).
MIN_MILLI_CPU = 10.0
MIN_MILLI_SCALAR = 10.0
MIN_MEMORY = 10.0 * 1024 * 1024

_CPU = "cpu"
_MEMORY = "memory"
_PODS = "pods"


def is_scalar_resource_name(name: str) -> bool:
    """Extended-resource-style names (domain-prefixed) and hugepages count
    as scalar resources, mirroring k8s v1helper.IsScalarResourceName as
    used by the reference (resource_info.go:85-88)."""
    return "/" in name or name.startswith("hugepages-")


class Resource:
    """Mutable resource vector with kube-batch arithmetic semantics."""

    __slots__ = ("milli_cpu", "memory", "scalars", "max_task_num")

    def __init__(
        self,
        milli_cpu: float = 0.0,
        memory: float = 0.0,
        scalars: Optional[dict[str, float]] = None,
        max_task_num: int = 0,
    ) -> None:
        self.milli_cpu = float(milli_cpu)
        self.memory = float(memory)
        self.scalars: dict[str, float] = dict(scalars) if scalars else {}
        # Pods capacity; predicates-only, excluded from arithmetic
        # (reference resource_info.go:38-39).
        self.max_task_num = int(max_task_num)

    # -- construction -------------------------------------------------------

    @classmethod
    def empty(cls) -> "Resource":
        return cls()

    @classmethod
    def from_resource_list(cls, rl: Optional[Mapping[str, float]]) -> "Resource":
        """Build from a resource list dict: "cpu" in cores, "memory" in bytes,
        "pods" as count, scalar resources in natural units — cpu and scalars
        are converted to milli-units (reference NewResource,
        resource_info.go:74-91, mirroring Quantity.MilliValue)."""
        r = cls()
        if not rl:
            return r
        for name, quant in rl.items():
            if name == _CPU:
                r.milli_cpu += float(quant) * 1000.0
            elif name == _MEMORY:
                r.memory += float(quant)
            elif name == _PODS:
                r.max_task_num += int(quant)
            elif is_scalar_resource_name(name):
                # Gated like the reference's IsScalarResourceName check
                # (resource_info.go:85-88): only extended resources
                # (domain-prefixed, e.g. nvidia.com/gpu) and hugepages are
                # tracked as scalars; other core names (ephemeral-storage)
                # are ignored.
                r.add_scalar(name, float(quant) * 1000.0)
        return r

    def clone(self) -> "Resource":
        r = Resource.__new__(Resource)
        r.milli_cpu = self.milli_cpu
        r.memory = self.memory
        r.scalars = dict(self.scalars)
        r.max_task_num = self.max_task_num
        return r

    # -- predicates ---------------------------------------------------------

    def is_empty(self) -> bool:
        """True when every dimension is below its epsilon
        (reference resource_info.go:94-106)."""
        if not (self.milli_cpu < MIN_MILLI_CPU and self.memory < MIN_MEMORY):
            return False
        return all(q < MIN_MILLI_SCALAR for q in self.scalars.values())

    def is_zero(self, name: str) -> bool:
        """True when the named dimension is below its epsilon
        (reference resource_info.go:109-126). Unknown scalar -> KeyError,
        matching the reference panic; a scalar never set reads as zero."""
        if name == _CPU:
            return self.milli_cpu < MIN_MILLI_CPU
        if name == _MEMORY:
            return self.memory < MIN_MEMORY
        if not self.scalars:
            return True
        if name not in self.scalars:
            raise KeyError(f"unknown resource {name!r}")
        return self.scalars[name] < MIN_MILLI_SCALAR

    def less(self, rr: "Resource") -> bool:
        """Strictly less in every dimension (reference resource_info.go:228-252).

        Go nil-map parity ({} == nil): when neither side has scalars the
        result is False even if cpu/memory are strictly less — this quirk
        gates preempt.validateVictims / reclaim / enqueue upstream."""
        if not (self.milli_cpu < rr.milli_cpu and self.memory < rr.memory):
            return False
        if not self.scalars:
            return bool(rr.scalars)
        for name, q in self.scalars.items():
            if not rr.scalars:
                return False
            if q >= rr.scalars.get(name, 0.0):
                return False
        return True

    def less_equal(self, rr: "Resource", dtype=None) -> bool:
        """Less-or-equal within epsilon per dimension — the admission check
        (reference resource_info.go:255-278). Go nil-map parity: a scalar
        entry on the left with no scalars at all on the right fails, even
        a zero-valued one.

        ``dtype`` (optional, e.g. numpy.float32) quantizes BOTH operands
        before comparing — the proportion overused/reclaimable gates pass
        the comparison dtype (api/numerics.py) so the serial gate rounds
        exactly as the f32 device gate does; one-sided rounding of a
        water-filled deserved against an on-grid allocated could
        otherwise flip the gate between the two paths."""
        if dtype is None:
            lc, rc_, lm, rm = self.milli_cpu, rr.milli_cpu, self.memory, rr.memory
        else:
            lc, rc_ = float(dtype(self.milli_cpu)), float(dtype(rr.milli_cpu))
            lm, rm = float(dtype(self.memory)), float(dtype(rr.memory))
        if not (lc < rc_ or abs(rc_ - lc) < MIN_MILLI_CPU):
            return False
        if not (lm < rm or abs(rm - lm) < MIN_MEMORY):
            return False
        for name, q in self.scalars.items():
            if not rr.scalars:
                return False
            rrq = rr.scalars.get(name, 0.0)
            if dtype is not None:
                q, rrq = float(dtype(q)), float(dtype(rrq))
            if not (q < rrq or abs(rrq - q) < MIN_MILLI_SCALAR):
                return False
        return True

    # -- arithmetic (mutating, returning self, like the reference) ----------

    def add(self, rr: "Resource") -> "Resource":
        self.milli_cpu += rr.milli_cpu
        self.memory += rr.memory
        for name, q in rr.scalars.items():
            self.scalars[name] = self.scalars.get(name, 0.0) + q
        return self

    def sub(self, rr: "Resource") -> "Resource":
        """Subtract; raises if rr does not fit (reference resource_info.go:146-166).

        Go nil-map parity: when the receiver has no scalars at all, scalar
        subtraction is skipped entirely (Sub's early return at :151-153) —
        no negative residue is ever created on a scalar-free receiver."""
        if not rr.less_equal(self):
            raise ValueError(
                f"Resource is not sufficient to do operation: <{self}> sub <{rr}>"
            )
        self.milli_cpu -= rr.milli_cpu
        self.memory -= rr.memory
        if self.scalars:
            for name, q in rr.scalars.items():
                self.scalars[name] = self.scalars.get(name, 0.0) - q
        return self

    def sub_overcommit(self, rr: "Resource") -> "Resource":
        """Subtract WITHOUT the fitness assertion — fields may go
        negative. For recording facts the store already committed (a
        bound pod arriving over the watch): two federated shards can
        race binds onto one node, and the mirror must reflect the
        overcommit rather than reject it. Negative idle reads as unfit
        to every less_equal admission check, so the local allocator
        naturally backs off the oversubscribed node."""
        self.milli_cpu -= rr.milli_cpu
        self.memory -= rr.memory
        if self.scalars:
            for name, q in rr.scalars.items():
                self.scalars[name] = self.scalars.get(name, 0.0) - q
        return self

    def set_max_resource(self, rr: "Resource") -> None:
        """Elementwise max, in place (reference resource_info.go:169-196)."""
        if rr is None:
            return
        self.milli_cpu = max(self.milli_cpu, rr.milli_cpu)
        self.memory = max(self.memory, rr.memory)
        for name, q in rr.scalars.items():
            if q > self.scalars.get(name, 0.0):
                self.scalars[name] = q

    def fit_delta(self, rr: "Resource") -> "Resource":
        """Subtract rr plus the per-dimension epsilon for every requested
        dimension; negative fields afterwards mean "insufficient"
        (reference resource_info.go:198-221). Used for NodesFitDelta
        diagnostics."""
        if rr.milli_cpu > 0:
            self.milli_cpu -= rr.milli_cpu + MIN_MILLI_CPU
        if rr.memory > 0:
            self.memory -= rr.memory + MIN_MEMORY
        for name, q in rr.scalars.items():
            if q > 0:
                self.scalars[name] = self.scalars.get(name, 0.0) - (q + MIN_MILLI_SCALAR)
        return self

    def multi(self, ratio: float) -> "Resource":
        self.milli_cpu *= ratio
        self.memory *= ratio
        for name in self.scalars:
            self.scalars[name] *= ratio
        return self

    # -- access -------------------------------------------------------------

    def get(self, name: str) -> float:
        """reference resource_info.go:293-305."""
        if name == _CPU:
            return self.milli_cpu
        if name == _MEMORY:
            return self.memory
        return self.scalars.get(name, 0.0)

    def resource_names(self) -> list[str]:
        return [_CPU, _MEMORY, *self.scalars.keys()]

    def add_scalar(self, name: str, quantity: float) -> None:
        self.scalars[name] = self.scalars.get(name, 0.0) + quantity

    def set_scalar(self, name: str, quantity: float) -> None:
        self.scalars[name] = quantity

    # -- tensor interface (solve path) --------------------------------------

    def to_vector(self, scalar_names: Sequence[str]) -> list[float]:
        """Lay out as one dense row [milli_cpu, memory, *scalars] following a
        fixed scalar-slot ordering. This is the Resource -> tensor-row
        contract of the solve path (SURVEY.md section 7 step 1)."""
        return [self.milli_cpu, self.memory, *(self.scalars.get(n, 0.0) for n in scalar_names)]

    @classmethod
    def from_vector(cls, vec: Iterable[float], scalar_names: Sequence[str]) -> "Resource":
        it = list(vec)
        scalars = {n: v for n, v in zip(scalar_names, it[2:]) if v != 0.0}
        return cls(milli_cpu=it[0], memory=it[1], scalars=scalars)

    @staticmethod
    def vector_epsilons(scalar_names: Sequence[str]) -> list[float]:
        """Per-slot epsilon vector aligned with ``to_vector`` layout."""
        return [MIN_MILLI_CPU, MIN_MEMORY, *([MIN_MILLI_SCALAR] * len(scalar_names))]

    # -- dunder -------------------------------------------------------------

    def __repr__(self) -> str:
        s = f"cpu {self.milli_cpu:.2f}, memory {self.memory:.2f}"
        for name, q in self.scalars.items():
            s += f", {name} {q:.2f}"
        return s

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Resource):
            return NotImplemented
        mine = {k: v for k, v in self.scalars.items() if v != 0.0}
        theirs = {k: v for k, v in other.scalars.items() if v != 0.0}
        return (
            self.milli_cpu == other.milli_cpu
            and self.memory == other.memory
            and mine == theirs
        )

    def __hash__(self):  # pragma: no cover - mutable; not hashable
        raise TypeError("Resource is mutable and unhashable")
