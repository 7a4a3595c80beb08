"""Executed multi-process distributed path (SURVEY section 2.5 backend row).

Spawns TWO OS processes that form a real ``jax.distributed`` cluster via
``mesh.initialize_multihost`` (gloo collectives over loopback TCP), build a
mesh whose 'map' axis spans both processes, and run

- the sharded blocked-EKF tick (sequential AND the production deferred
  variant), and
- the sharded Schur Gauss-Newton refinement,

asserting shard-for-shard equality with process-local executions of the same
programs (and, for the GN step, with the single-device implementation). The
virtual-mesh tests prove the collectives' math; this one proves the
multi-host runtime path — coordinator bring-up, cross-process collectives,
global-array construction — actually executes.
"""

import os
import socket
import subprocess
import sys



HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "multihost_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_workers(extra_args=()):
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"       # workers never open an accelerator
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    return [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", str(port),
             *map(str, extra_args)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=HERE)
        for pid in range(2)
    ]


def _wait_ok(procs, marker, timeout=540):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"pid={pid} {marker}" in out, out


def test_two_process_cluster():
    _wait_ok(_spawn_workers(), "MULTIHOST_OK")


def test_two_process_cluster_config4_scale():
    """Deferred blocked step at N=2048/M=8 across the process boundary —
    the per-tick O(MN) strip all_gathers at representative config-4 sizes
    (VERDICT r02 item 5)."""
    _wait_ok(_spawn_workers(["bign"]), "MULTIHOST_BIGN_OK")


def test_two_process_checkpoint_restart(tmp_path):
    """Failure recovery across jax.distributed (SURVEY §5 failure-recovery
    row): both workers write a sharded checkpoint mid-run, are KILLED while
    still computing, and a fresh cluster restores and finishes the rollout
    bitwise-identical to an uninterrupted run."""
    import time

    save_dir = str(tmp_path)
    procs = _spawn_workers(["ckpt_save", save_dir])
    try:
        deadline = time.time() + 300
        want = {os.path.join(save_dir, f"saved.{pid}") for pid in range(2)}
        while time.time() < deadline:
            if all(os.path.exists(f) for f in want):
                break
            if any(p.poll() is not None for p in procs):
                raise AssertionError(
                    "ckpt_save worker exited early:\n"
                    + "\n".join(p.communicate()[0] for p in procs
                                if p.poll() is not None))
            time.sleep(0.5)
        else:
            raise AssertionError("checkpoint files never appeared")
        # both checkpoints written; kill the cluster mid-run (exact PIDs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p in procs:
        p.wait(timeout=60)

    _wait_ok(_spawn_workers(["ckpt_resume", save_dir]), "MULTIHOST_CKPT_OK")
