"""The port's process utilities against the JAX package's:
``utils.workqueue.RateLimitingQueue`` (the cache's errTasks and
deletedJobs queues) on the same sequence of operations, and
``utils.locking.LockOrderWitness`` on the same acquisition orders."""

from __future__ import annotations

import threading

import pytest

import kube_batch_tpu.utils.locking as jax_locking
import kube_batch_tpu.utils.workqueue as jax_workqueue
import kube_batch_tpu_torch.utils.locking as port_locking
import kube_batch_tpu_torch.utils.workqueue as port_workqueue

BOTH = [pytest.param((jax_workqueue, jax_locking), id="jax"), pytest.param((port_workqueue, port_locking), id="port")]


def queue_script(wq) -> list:
    """Adds, coalescing, rate-limited delays, the processing set, forget,
    shut-down and restart: what each call returns, in order."""
    q = wq.RateLimitingQueue(key_fn=lambda item: item["k"])
    out = []
    q.add({"k": "a", "v": 1})
    q.add({"k": "a", "v": 2})  # coalesces; the newest payload wins
    q.add({"k": "b", "v": 1})
    out.append(len(q))
    a = q.get(timeout=1)
    out.append(a)
    q.add({"k": "a", "v": 3})  # re-added while processing: dirty
    out.append(len(q))
    q.done(a)
    out.append(q.get(timeout=1))
    out.append(q.get(timeout=1))
    for item in ({"k": "b", "v": 1}, {"k": "a", "v": 3}):
        q.done(item)
    q.add_rate_limited({"k": "c", "v": 1})
    q.add_rate_limited({"k": "c", "v": 1})
    out.append(q.failures({"k": "c"}))
    out.append(q.get(timeout=1))  # after its 5 ms delay
    q.done({"k": "c"})
    q.forget({"k": "c"})
    out.append(q.failures({"k": "c"}))
    q.shut_down()
    q.add({"k": "d", "v": 1})  # dropped: shut down
    out.append(q.get(timeout=0.01))
    q.restart()
    q.add({"k": "e", "v": 1})
    out.append(q.get(timeout=1))
    out.append(len(q))
    return out


def test_the_rate_limiting_queue_equals_the_jax_queue():
    port, jax = queue_script(port_workqueue), queue_script(jax_workqueue)
    assert port == jax
    assert port[1] == {"k": "a", "v": 2} and port[3] == {"k": "b", "v": 1} and port[4] == {"k": "a", "v": 3}
    assert port[5:] == [2, {"k": "c", "v": 1}, 0, None, {"k": "e", "v": 1}, 1]


@pytest.mark.parametrize("mods", BOTH)
def test_the_rate_limited_delay_doubles_to_its_cap(mods):
    wq, _ = mods
    q = wq.RateLimitingQueue()
    delays = [q._delay("x") for _ in range(10)]
    assert delays == [min(0.005 * 2**n, 1.0) for n in range(10)]


def witness_script(lk) -> list:
    w = lk.LockOrderWitness()
    a = w.wrap("A", threading.Lock())
    b = w.wrap("B", threading.RLock())
    with a:
        with b:
            pass
    ok = list(w.violations)

    def reversed_order():
        with b:
            with a:
                pass

    t = threading.Thread(target=reversed_order, name="reverser")
    t.start()
    t.join()
    got = list(w.violations)
    try:
        w.assert_clean()
        raised = False
    except AssertionError:
        raised = True
    return [ok, got, raised]


def test_the_lock_order_witness_equals_the_jax_witness():
    port, jax = witness_script(port_locking), witness_script(jax_locking)
    assert port == jax
    assert port[0] == [] and len(port[1]) == 1 and "B -> A" in port[1][0] and port[2]


def test_assume_locked_marks_the_function():
    @port_locking.assume_locked
    def helper():
        return 1

    assert helper() == 1 and helper.__assume_locked__ is True
