"""The port's multi-process tier (``parallel.multihost``) over
``torch.distributed``.

- ``process_shard`` equals the reference's over a grid of list lengths
  and process counts, and covers every item once;
- ``initialize()`` without the ``JAX_*`` variables is a no-op returning
  ``(0, 1)``, and ``global_mesh`` is this process's 1-D mesh;
- two real processes form a gloo group from the reference's variables,
  take their shares and sum across the group; the test skips, as
  ``tests/test_multihost.py`` does, where local TCP is blocked.
"""

import os
import pathlib
import socket
import subprocess
import sys

import pytest

from videomorphing_tpu.parallel.multihost import process_shard as jax_process_shard
from videomorphing_tpu_torch.parallel import multihost

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("n_items", [0, 1, 5, 10, 17])
def test_process_shard_matches_reference(n_items):
    items = list(range(n_items))
    for n_proc in (1, 2, 3, 4, 7):
        shares = [multihost.process_shard(items, pid, n_proc) for pid in range(n_proc)]
        assert shares == [jax_process_shard(items, pid, n_proc) for pid in range(n_proc)]
        assert sum(shares, []) == items


def test_initialize_without_variables_is_a_no_op(monkeypatch):
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() == (0, 1)
    assert multihost.process_shard(list(range(4))) == [0, 1, 2, 3]
    mesh = multihost.global_mesh(devices=["cpu"])
    assert mesh.shape == {"batch": 1} and str(mesh.devices[0]) == "cpu"


_WORKER = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from videomorphing_tpu_torch.parallel.multihost import global_mesh, initialize, process_shard

pid, n = initialize(device="cpu")
assert n == 2 and dist.get_backend() == "gloo", (pid, n)
mine = process_shard(list(range(10)))
assert mine == ([0, 1, 2, 3, 4] if pid == 0 else [5, 6, 7, 8, 9]), (pid, mine)
x = torch.tensor([float(sum(mine))])
dist.all_reduce(x)
assert float(x) == 45.0, float(x)
assert global_mesh(devices=["cpu"]).shape == {"batch": 1}
dist.destroy_process_group()
print(f"proc {pid}: OK", flush=True)
"""


def test_two_process_group(tmp_path):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES="2")
    procs = [
        subprocess.Popen([sys.executable, str(script), str(ROOT)], env=dict(env, JAX_PROCESS_ID=str(pid)),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.skip("local TCP blocked: the torch.distributed group cannot form here (timeout)")
    if any(p.returncode != 0 for p in procs):
        msg = "\n".join(outs)
        if "Connection refused" in msg or "connect" in msg.lower() and "timed out" in msg.lower():
            pytest.skip("local TCP blocked: the torch.distributed group cannot form here")
        raise AssertionError(msg)
    assert all("OK" in o for o in outs), outs
