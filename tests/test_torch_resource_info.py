"""The port's ``Resource`` arithmetic (kube_batch_tpu_torch/api/resource_info.py),
case for case with tests/test_resource_info.py.

Every JAX case keeps its name and its assertions, and runs on both
packages: each case is a function of the package's namespace that checks
the reference's expectation and returns what it read as plain values, and
the test asserts the two packages read the same. The parametrized cases
keep their parameters (``test_is_empty``'s six, ``test_less``'s six,
``test_less_equal_epsilon``'s seven). No JAX case is left out.
"""

from __future__ import annotations

import types
from importlib import import_module

import pytest


def _ns(root: str) -> types.SimpleNamespace:
    api = import_module(f"{root}.api")
    ri = import_module(f"{root}.api.resource_info")
    return types.SimpleNamespace(
        name=root, Resource=api.Resource, MIN_MEMORY=ri.MIN_MEMORY, MIN_MILLI_CPU=ri.MIN_MILLI_CPU,
        MIN_MILLI_SCALAR=ri.MIN_MILLI_SCALAR,
    )


JAX, PORT = _ns("kube_batch_tpu"), _ns("kube_batch_tpu_torch")
MIN_MILLI_CPU, MIN_MEMORY, MIN_MILLI_SCALAR = PORT.MIN_MILLI_CPU, PORT.MIN_MEMORY, PORT.MIN_MILLI_SCALAR


def both(case, *args):
    """Run ``case(P, *args)`` on both packages; their readings must agree."""
    assert (JAX.MIN_MILLI_CPU, JAX.MIN_MEMORY, JAX.MIN_MILLI_SCALAR) == (MIN_MILLI_CPU, MIN_MEMORY, MIN_MILLI_SCALAR)
    ref, got = case(JAX, *args), case(PORT, *args)
    assert got == ref


def res(P, mcpu=0.0, mem=0.0, scalars=None):
    return P.Resource(milli_cpu=mcpu, memory=mem, scalars=scalars)


def plain(r) -> tuple:
    return (r.milli_cpu, r.memory, dict(r.scalars or {}), r.max_task_num)


# -- construction ----------------------------------------------------------------


def test_from_resource_list_converts_units():
    def case(P):
        r = P.Resource.from_resource_list({"cpu": 2, "memory": 3 * 2**30, "pods": 10, "nvidia.com/gpu": 1})
        assert r.milli_cpu == 2000
        assert r.memory == 3 * 2**30
        assert r.max_task_num == 10
        assert r.scalars["nvidia.com/gpu"] == 1000
        return plain(r)

    both(case)


def test_empty_and_none():
    def case(P):
        assert P.Resource.from_resource_list(None) == P.Resource.empty()
        assert P.Resource.from_resource_list({}).is_empty()
        return plain(P.Resource.empty())

    both(case)


def test_clone_is_deep():
    def case(P):
        r = res(P, 1000, 100, {"nvidia.com/gpu": 1000})
        c = r.clone()
        c.add(res(P, 1, 1, {"nvidia.com/gpu": 1}))
        assert r == res(P, 1000, 100, {"nvidia.com/gpu": 1000})
        assert c != r
        return plain(r), plain(c)

    both(case)


# -- predicates ------------------------------------------------------------------


@pytest.mark.parametrize(
    "r,expected",
    [
        ((0, 0, None), True),
        ((MIN_MILLI_CPU - 1, MIN_MEMORY - 1, None), True),
        ((MIN_MILLI_CPU, 0, None), False),
        ((0, MIN_MEMORY, None), False),
        ((0, 0, {"nvidia.com/gpu": MIN_MILLI_SCALAR}), False),
        ((0, 0, {"nvidia.com/gpu": MIN_MILLI_SCALAR - 1}), True),
    ],
)
def test_is_empty(r, expected):
    def case(P):
        got = res(P, *r).is_empty()
        assert got is expected
        return got

    both(case)


def test_is_zero():
    def case(P):
        r = res(P, 5, 5, {"nvidia.com/gpu": 5})
        assert r.is_zero("cpu")
        assert r.is_zero("memory")
        assert r.is_zero("nvidia.com/gpu")
        with pytest.raises(KeyError):
            r.is_zero("google.com/tpu")
        assert P.Resource.empty().is_zero("whatever")  # no scalars at all -> zero
        return True

    both(case)


@pytest.mark.parametrize(
    "l,r,expected",
    [
        # the Go nil-map quirk: both scalar-free -> False even when less
        ((100, 100, None), (200, 200, None), False),
        ((100, 100, None), (100, 200, None), False),  # not strictly less on cpu
        ((100, 100, None), (200, 200, {"g": 2}), True),
        ((100, 100, {"g": 1}), (200, 200, {"g": 2}), True),
        ((100, 100, {"g": 2}), (200, 200, {"g": 2}), False),
        ((100, 100, {"g": 1}), (200, 200, None), False),  # scalar missing on r
    ],
)
def test_less(l, r, expected):
    def case(P):
        got = res(P, *l).less(res(P, *r))
        assert got is expected
        return got

    both(case)


def test_less_policy_call_sites():
    def case(P):
        victims_total = res(P, 500, 500)  # cpu/mem only
        resreq = res(P, 1000, 1000)
        assert victims_total.less(resreq) is False  # Go: both nil -> False
        assert res(P, 500, 500, {"g": 1}).less(res(P, 1000, 1000, {"g": 2})) is True
        return True

    both(case)


@pytest.mark.parametrize(
    "l,r,expected",
    [
        ((100, 100, None), (100, 100, None), True),  # equal within epsilon
        ((100 + MIN_MILLI_CPU - 1, 100, None), (100, 100, None), True),
        ((100 + MIN_MILLI_CPU, 100, None), (100, 100, None), False),
        ((0, 100 + MIN_MEMORY, None), (0, 100, None), False),
        ((0, 0, {"g": 5}), (0, 0, None), False),
        ((0, 0, {"g": 5}), (0, 0, {"h": 1}), True),  # epsilon vs present map
        ((0, 0, {"g": MIN_MILLI_SCALAR}), (0, 0, None), False),
    ],
)
def test_less_equal_epsilon(l, r, expected):
    def case(P):
        got = res(P, *l).less_equal(res(P, *r))
        assert got is expected
        return got

    both(case)


# -- arithmetic ------------------------------------------------------------------


def test_add():
    def case(P):
        r = res(P, 100, 100, {"g": 1}).add(res(P, 50, 50, {"g": 1, "t": 2}))
        assert r == res(P, 150, 150, {"g": 2, "t": 2})
        return plain(r)

    both(case)


def test_sub():
    def case(P):
        r = res(P, 100, 100, {"g": 2}).sub(res(P, 50, 50, {"g": 1}))
        assert r == res(P, 50, 50, {"g": 1})
        return plain(r)

    both(case)


def test_sub_underflow_raises():
    def case(P):
        with pytest.raises(ValueError) as e:
            res(P, 100, 100).sub(res(P, 200, 100))
        return str(e.value)

    both(case)


def test_sub_within_epsilon_allowed():
    def case(P):
        r = res(P, 100, 100).sub(res(P, 100 + MIN_MILLI_CPU / 2, 100))
        assert r.milli_cpu == pytest.approx(-MIN_MILLI_CPU / 2)
        return plain(r)

    both(case)


def test_set_max_resource():
    def case(P):
        r = res(P, 100, 300, {"g": 1})
        r.set_max_resource(res(P, 200, 200, {"g": 0.5, "t": 4}))
        assert r == res(P, 200, 300, {"g": 1, "t": 4})
        return plain(r)

    both(case)


def test_fit_delta_epsilon_margin():
    def case(P):
        r = res(P, 100, 100).fit_delta(res(P, 100, 0))
        assert r.milli_cpu == -MIN_MILLI_CPU  # 100 - (100 + eps)
        assert r.memory == 100  # memory not requested -> untouched
        return plain(r)

    both(case)


def test_fit_delta_scalar():
    def case(P):
        r = res(P, 0, 0, {"g": 500}).fit_delta(res(P, 0, 0, {"g": 1000}))
        assert r.scalars["g"] == 500 - 1000 - MIN_MILLI_SCALAR
        return plain(r)

    both(case)


def test_multi():
    def case(P):
        r = res(P, 100, 100, {"g": 3}).multi(2)
        assert r == res(P, 200, 200, {"g": 6})
        return plain(r)

    both(case)


def test_max_task_num_excluded_from_arithmetic():
    def case(P):
        a = P.Resource.from_resource_list({"pods": 10, "cpu": 1})
        b = P.Resource.from_resource_list({"pods": 20, "cpu": 1})
        a.add(b)
        assert a.max_task_num == 10  # untouched by Add (resource_info.go:38-39)
        return plain(a)

    both(case)


# -- access and the vector interface ---------------------------------------------


def test_get():
    def case(P):
        r = res(P, 100, 200, {"g": 3})
        got = (r.get("cpu"), r.get("memory"), r.get("g"), r.get("missing"))
        assert got == (100, 200, 3, 0)
        return got

    both(case)


def test_resource_names():
    def case(P):
        names = res(P, 0, 0, {"g": 1}).resource_names()
        assert names == ["cpu", "memory", "g"]
        return names

    both(case)


def test_roundtrip():
    def case(P):
        r = res(P, 1500, 2**30, {"nvidia.com/gpu": 2000})
        names = ["nvidia.com/gpu", "google.com/tpu"]
        vec = r.to_vector(names)
        assert vec == [1500, 2**30, 2000, 0.0]
        assert P.Resource.from_vector(vec, names) == r
        return vec

    both(case)


def test_epsilons_align():
    def case(P):
        eps = P.Resource.vector_epsilons(["nvidia.com/gpu"])
        assert eps == [MIN_MILLI_CPU, MIN_MEMORY, MIN_MILLI_SCALAR]
        return eps

    both(case)
