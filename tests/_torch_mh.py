"""Spawn the ranks of a multi-process run of the PyTorch port on the CPU:
gloo over a TCP rendezvous on a free local port, each rank in its own
interpreter (``tests/_torch_mh_worker.py``), each waited on with a
timeout."""

import os
import pickle
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_mh_worker.py")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_env(world: int, rank: int, port: int) -> dict:
    env = dict(os.environ)
    env.update(VES_COORDINATOR=f"127.0.0.1:{port}",
               VES_NUM_PROCESSES=str(world), VES_PROCESS_ID=str(rank),
               OMP_NUM_THREADS="1")
    return env


def run_processes(cmds, timeout: float, cwd=None):
    """Start one process per (argv, env) and wait for all; kill every one
    and fail at ``timeout`` seconds. Returns their (rc, stdout, stderr)."""
    procs = [subprocess.Popen(argv, env=env, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv, env in cmds]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"ranks did not finish in {timeout} s")
    return outs


def run_ranks(case: str, inp: dict, world: int, tmp_path,
              timeout: float = 300.0) -> list:
    """Each rank's pickled result of ``case`` on ``inp``."""
    tag = f"{case}_{world}_{len(os.listdir(tmp_path))}"
    inp_path = os.path.join(tmp_path, tag + ".in.pkl")
    with open(inp_path, "wb") as f:
        pickle.dump(inp, f)
    port = free_port()
    outs = [os.path.join(tmp_path, f"{tag}.r{r}.pkl") for r in range(world)]
    res = run_processes(
        [([sys.executable, WORKER, case, inp_path, outs[r]],
          rank_env(world, r, port)) for r in range(world)], timeout)
    for r, (rc, out, err) in enumerate(res):
        assert rc == 0, f"rank {r} rc {rc}:\n{out[-2000:]}\n{err[-4000:]}"
    results = []
    for o in outs:
        with open(o, "rb") as f:
            results.append(pickle.load(f))
    return results
