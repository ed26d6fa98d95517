"""The port's multi-process bootstrap (parallel/multihost.py), as
tests/test_multihost.py: two OS processes join a gloo group on localhost
through multihost.initialize, run cross-process all_reduce steps and
checkpoint their progress. The fault run kills process 1 mid-loop and
asserts the survivor stops making progress (its all_reduce on the lost
connection raises, or stalls: either is the failure signal); the recovery
run restarts both from the checkpoint and asserts completion from where
it left off."""

import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys, time
import numpy as np
import torch
import torch.distributed as dist

addr, pid, steps, ckpt, fault_step = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
    int(sys.argv[5]))

from visualslam_tpu_torch.parallel import multihost

started = multihost.initialize(addr, num_processes=2, process_id=pid,
                               device="cpu")
assert started, "multi-process init did not start"
assert dist.get_world_size() == 2
assert multihost.is_coordinator() == (pid == 0)

start = 0
if os.path.exists(ckpt):
    start = int(np.load(ckpt)["step"]) + 1

for step in range(start, steps):
    y = torch.ones(4) * (pid + 1)
    try:
        dist.all_reduce(y)
    except Exception as e:
        print("ALL_REDUCE_RAISED", type(e).__name__, flush=True)
        raise
    np.testing.assert_allclose(y.numpy(), 3.0)          # 1 + 2
    if pid == 0:
        np.savez(ckpt + ".tmp.npz", step=step)   # savez appends .npz itself
        os.replace(ckpt + ".tmp.npz", ckpt)
        with open(ckpt + ".progress", "a") as fh:
            fh.write(f"{step}\n")
    if pid == 1 and fault_step >= 0 and step == fault_step:
        os._exit(17)          # simulated host loss mid-run
    time.sleep(0.05)
dist.destroy_process_group()
print("DONE", pid, flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(pid, addr, steps, ckpt, fault_step, tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + (
        os.pathsep + env["PYTHONPATH"] if "PYTHONPATH" in env else "")
    env["OMP_NUM_THREADS"] = "1"
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    return subprocess.Popen(
        [sys.executable, str(script), addr, str(pid), str(steps),
         str(ckpt), str(fault_step)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT)


def _progress(ckpt):
    try:
        with open(str(ckpt) + ".progress") as fh:
            lines = fh.read().split()
        return int(lines[-1]) if lines else -1
    except FileNotFoundError:
        return -1


def test_multihost_initialize_noop_paths(monkeypatch):
    from visualslam_tpu_torch.parallel import multihost

    monkeypatch.delenv("SLAM_COORDINATOR", raising=False)
    assert multihost.initialize() is False          # no coordinator set
    assert multihost.initialize("127.0.0.1:1", num_processes=1) is False
    monkeypatch.setenv("SLAM_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("SLAM_NUM_PROCESSES", "1")
    assert multihost.initialize() is False          # single process: no-op
    assert multihost.is_coordinator()               # no group: coordinator


def test_fault_injection_and_checkpoint_recovery(tmp_path):
    addr = f"127.0.0.1:{_free_port()}"
    ckpt = tmp_path / "state.npz"
    steps, fault_step = 40, 8

    # --- phase 1: run with a fault injected at step 8 on process 1 ---
    p0 = _spawn(0, addr, steps, ckpt, -1, tmp_path)
    p1 = _spawn(1, addr, steps, ckpt, fault_step, tmp_path)
    assert p1.wait(timeout=120) == 17, "fault process should self-kill"
    # the survivor must STOP making progress: give it a grace window, then
    # require the step counter to be frozen at / near the fault step
    time.sleep(6)
    prog_a = _progress(ckpt)
    time.sleep(3)
    prog_b = _progress(ckpt)
    assert prog_a <= fault_step + 2, f"survivor ran past fault: {prog_a}"
    assert prog_b == prog_a, "survivor kept advancing without its peer"
    if p0.poll() is None:
        p0.kill()
    out_fault, _ = p0.communicate()
    # gloo's all_reduce raises on the closed connection (or the survivor
    # stalls inside it and is killed): either way it never finished
    assert "DONE" not in out_fault
    assert p0.returncode != 0

    # --- phase 2: restart both processes; they resume from checkpoint ---
    addr2 = f"127.0.0.1:{_free_port()}"
    q0 = _spawn(0, addr2, steps, ckpt, -1, tmp_path)
    q1 = _spawn(1, addr2, steps, ckpt, -1, tmp_path)
    out0, _ = q0.communicate(timeout=180)
    out1, _ = q1.communicate(timeout=180)
    assert q0.returncode == 0, out0[-2000:]
    assert q1.returncode == 0, out1[-2000:]
    assert "DONE 0" in out0 and "DONE 1" in out1
    with open(str(ckpt) + ".progress") as fh:
        prog = [int(x) for x in fh.read().split()]
    assert max(prog) == steps - 1 and prog[-1] == steps - 1
    # resumed, not restarted from scratch: one pass from 0, and the
    # resumed run starts right after the last checkpointed step
    assert prog.count(0) == 1
    k = prog.index(prog_b) + 1
    assert prog[k:] == list(range(prog_b + 1, steps))
