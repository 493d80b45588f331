"""Build sentinel: count kernel builds and library loads inside a region.

A kernel rebuilt in the warm scheduling loop is the most expensive
latent regression the card's path can grow: one ``nvcc`` run costs
seconds, more than a thousand warm cycles, and it is invisible to every
source-level lint. It happens when a kernel source or a header it hashes
changes under a running scheduler, or when a library is loaded again.
``ops/nvcc.py`` counts both (``nvcc.builds``: compiler processes
started; ``nvcc.loads``: libraries loaded); :class:`CompileSentinel`
turns the two counters into an assertable budget:

    with CompileSentinel("warm cycles", budget=0) as cs:
        for _ in range(3):
            sched.run_once()
    # raises CompileBudgetExceeded if anything was built or loaded

The names are the JAX package's (its sentinel counts XLA compiles, the
counterpart of a kernel build here). Counts are process-wide: a build on
a side thread inside the region counts too.
"""

from __future__ import annotations

__all__ = ["CompileBudgetExceeded", "CompileSentinel"]


def _counts() -> tuple[int, int]:
    from kube_batch_tpu_torch.ops import nvcc

    return nvcc.builds, nvcc.loads


class CompileBudgetExceeded(AssertionError):
    """A sentinel region built or loaded more kernels than its budget allows."""


class CompileSentinel:
    """Context manager counting kernel builds and library loads in its
    region.

    ``budget=None`` observes only (read ``.compiles``, ``.builds`` and
    ``.loads`` after exit); ``budget=N`` raises
    :class:`CompileBudgetExceeded` on exit when the region built or loaded
    more than N. An exception already in flight wins: the sentinel never
    masks it.
    """

    def __init__(self, label: str = "", budget: int | None = None) -> None:
        self.label = label
        self.budget = budget
        self.compiles = 0
        self.builds = 0
        self.loads = 0
        self._start = (0, 0)

    def __enter__(self) -> "CompileSentinel":
        self._start = _counts()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        builds, loads = _counts()
        self.builds = builds - self._start[0]
        self.loads = loads - self._start[1]
        self.compiles = self.builds + self.loads
        if exc_type is None and self.budget is not None and self.compiles > self.budget:
            what = f" [{self.label}]" if self.label else ""
            raise CompileBudgetExceeded(
                f"build sentinel{what}: {self.builds} kernel builds and "
                f"{self.loads} library loads in a region budgeted for "
                f"{self.budget} — a warm path is rebuilding (a kernel "
                "source or header changed, or a library was loaded again)"
            )
        return False
