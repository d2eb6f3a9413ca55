"""The port's supervised worker pool (``repro_torch.serve.supervisor``):
the reference's seven pool cases (crash detection, restart, re-dispatch,
typed failures, every Future resolved) on the port's ``echo_task``, which
loads neither torch nor JAX in the workers; then the port's
``mapping_task`` on the CPU against the direct path, and the pool's CUDA
contract (``fork`` refused for a CUDA pool)."""
import dataclasses
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core import graph as TG
from repro_torch.core.api import SharedMapConfig, shared_map_direct
from repro_torch.core.hierarchy import Hierarchy
from repro_torch.faults import FaultInjector
from repro_torch.serve.supervisor import (SupervisedWorkerPool, WorkerCrashError,
                                          WorkerPoolClosedError, mapping_task)

ROOT = Path(__file__).resolve().parent.parent
ECHO = "repro_torch.serve.supervisor:echo_task"
FAST = {"restart_backoff_s": 0.01, "poll_s": 0.01}


def test_roundtrip_and_error_propagation():
    with SupervisedWorkerPool(2, **FAST) as pool:
        futs = [pool.submit(ECHO, {"x": i}) for i in range(8)]
        assert sorted(f.result(timeout=60)["x"] for f in futs) == list(range(8))
        bad = pool.submit(ECHO, {"raise": "kaboom"})
        with pytest.raises(ValueError, match="kaboom"):
            bad.result(timeout=60)
        s = pool.stats()
        assert s["ok"] == 8 and s["err"] == 1 and s["crashes"] == 0


def test_injected_sigkill_mid_request_future_still_resolves():
    inj = FaultInjector(fail_at={"worker_kill": (0,)})
    with SupervisedWorkerPool(2, fault_injector=inj, **FAST) as pool:
        fut = pool.submit(ECHO, {"x": 7, "sleep_s": 0.3})
        assert fut.result(timeout=60)["x"] == 7  # zero unresolved futures
        s = pool.stats()
        assert s["killed_injected"] == 1
        assert s["crashes"] >= 1
        assert s["restarts"] >= 1
        assert s["redispatched"] >= 1
        assert inj.fired and inj.fired[0][0] == "worker_kill"


def test_external_sigkill_detected_and_restarted():
    with SupervisedWorkerPool(1, **FAST) as pool:
        fut = pool.submit(ECHO, {"x": 1, "sleep_s": 1.0})
        deadline = time.monotonic() + 10
        pid = None
        while time.monotonic() < deadline and pid is None:
            w = pool._workers[0]
            if w.task is not None and w.alive():
                pid = w.proc.pid
            else:
                time.sleep(0.01)
        assert pid is not None
        os.kill(pid, signal.SIGKILL)
        assert fut.result(timeout=60)["x"] == 1
        s = pool.stats()
        assert s["crashes"] >= 1 and s["redispatched"] >= 1


def test_repeat_crasher_fails_typed_and_transient():
    with SupervisedWorkerPool(1, max_redispatch=1, **FAST) as pool:
        fut = pool.submit(ECHO, {"die": True})
        with pytest.raises(WorkerCrashError) as ei:
            fut.result(timeout=120)
        assert ei.value.transient is True  # feeds the service retry ladder
        assert ei.value.redispatches == 1
        s = pool.stats()
        assert s["crash_failed"] == 1 and s["crashes"] >= 2
        # the pool survives its crasher: a clean task still runs
        assert pool.submit(ECHO, {"x": 5}).result(timeout=60)["x"] == 5


def test_restart_backoff_is_capped_exponential():
    with SupervisedWorkerPool(1, max_redispatch=3, restart_backoff_s=0.05,
                              restart_backoff_cap_s=0.1, poll_s=0.01) as pool:
        fut = pool.submit(ECHO, {"die": True})
        with pytest.raises(WorkerCrashError):
            fut.result(timeout=120)
        w = pool._workers[0]
        assert w.consecutive_crashes >= 4
        # a completed task resets the crash streak
        assert pool.submit(ECHO, {"x": 1}).result(timeout=60)["x"] == 1
        assert pool._workers[0].consecutive_crashes == 0


def test_close_fails_pending_futures():
    pool = SupervisedWorkerPool(1, **FAST)
    slow = pool.submit(ECHO, {"sleep_s": 30})
    queued = pool.submit(ECHO, {"x": 2})
    pool.close(wait=False)
    with pytest.raises(WorkerPoolClosedError):
        queued.result(timeout=10)
    with pytest.raises(WorkerPoolClosedError):
        slow.result(timeout=10)
    with pytest.raises(WorkerPoolClosedError):
        pool.submit(ECHO, {"x": 3})


def test_burst_with_random_kills_all_futures_resolve():
    """Under repeated injected SIGKILLs every submitted future resolves
    (result or typed error)."""
    inj = FaultInjector(fail_at={"worker_kill": (1, 3, 5)})
    with SupervisedWorkerPool(2, fault_injector=inj, max_redispatch=3,
                              **FAST) as pool:
        futs = [pool.submit(ECHO, {"x": i, "sleep_s": 0.05})
                for i in range(12)]
        done = 0
        for f in futs:
            try:
                f.result(timeout=120)
                done += 1
            except WorkerCrashError:
                done += 1  # typed resolution still counts as resolved
        assert done == 12
        assert all(f.done() for f in futs)


def test_exit_after_a_worker_killed_mid_payload():
    """A worker SIGKILLed while a payload larger than the pipe's buffer is
    still in its inbox leaves that queue's feeder thread blocked for good;
    the pool must not let the interpreter join it at exit (the JAX
    package's pool hangs there). Run in a child interpreter, which must
    resolve the request and exit."""
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "from repro_torch.faults import FaultInjector\n"
            "from repro_torch.serve.supervisor import SupervisedWorkerPool\n"
            "if __name__ == '__main__':\n"
            "    inj = FaultInjector(fail_at={'worker_kill': (0,)})\n"
            "    with SupervisedWorkerPool(1, fault_injector=inj, restart_backoff_s=0.01,\n"
            "                              poll_s=0.01) as pool:\n"
            "        out = pool.submit('repro_torch.serve.supervisor:echo_task',\n"
            "                          {'blob': b'x' * (16 << 20)}).result(timeout=60)\n"
            "        assert len(out['blob']) == 16 << 20\n"
            "        assert pool.stats()['killed_injected'] == 1\n"
            "    print('closed')\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT / "src")], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "closed", out.stderr


def _payload(g, h, cfg, device="cpu"):
    n, m = int(g.n), int(g.m)
    return {"vwgt": g.vwgt[:n].numpy(), "rows": g.rows[:m].numpy(),
            "cols": g.cols[:m].numpy(), "ewgt": g.ewgt[:m].numpy(),
            "n": n, "N": g.N, "M": g.M, "a": h.a, "d": h.d,
            "cfg": dataclasses.asdict(cfg),
            "timeout_s": None, "resident": None, "device": device}


@pytest.mark.parametrize("strategy", ["bucket", "device"])
def test_mapping_task_equals_the_direct_path(strategy):
    """The worker-side task, called in this process on the CPU: the
    request rebuilt from its numpy payload gives the direct path's result."""
    g = TG.gen_rgg(300, seed=41, device="cpu")
    h = Hierarchy((4, 2), (1.0, 10.0))
    cfg = SharedMapConfig(preset="fast", strategy=strategy)
    out = mapping_task(_payload(g, h, cfg))
    ref = shared_map_direct(g, h, cfg, device="cpu")
    assert np.array_equal(out["pe_of"], ref.pe_of) and out["J"] == ref.J
    assert out["stats"]["backend"] == "xla" and out["stats"]["strategy"] == strategy


def test_mapping_task_in_a_worker_process():
    g = TG.gen_rgg(300, seed=42, device="cpu")
    h = Hierarchy((4, 2), (1.0, 10.0))
    cfg = SharedMapConfig(preset="fast")
    with SupervisedWorkerPool(1, **FAST) as pool:
        out = pool.submit("repro_torch.serve.supervisor:mapping_task",
                          _payload(g, h, cfg)).result(timeout=300)
    ref = shared_map_direct(g, h, cfg, device="cpu")
    assert np.array_equal(out["pe_of"], ref.pe_of) and out["J"] == ref.J


def test_cuda_pool_refuses_fork():
    """A forked child of a process that initialised CUDA cannot use the
    card: a CUDA pool must spawn. The check comes before anything is built
    or spawned, so it holds without a card."""
    with pytest.raises(ValueError, match="fork"):
        SupervisedWorkerPool(1, ctx="fork", device="cuda")
