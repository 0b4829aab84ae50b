"""The port's multi-host batch (``parallel/multihost.py`` on
``torch.distributed``) against the JAX package's, on the CPU:

- ``shard_items`` gives JAX's shares of the same lists, for every process
  of 1 to 4 (exact), and ``allgather_counts`` without a group returns the
  process's own row, as JAX's does with one process;
- two processes form a gloo group over a local TCP coordinator
  (``init_multihost``), take disjoint round-robin shares and gather the
  same counts (JAX's ``test_multihost.py:33-80`` worker);
- a two-process ``--batch --multihost`` run of the port's CLI on ``--cpu``
  (``WORLD_SIZE``/``RANK``, ``--coordinator``): each process takes 2 of
  the 4 videos and both report 4/4, and the outputs equal a one-process
  batch run byte for byte; ``--multihost`` without a coordinator exits 1.

Every subprocess has its own timeout, so that a hang fails in seconds.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from video_restore_tpu_torch import cli
from video_restore_tpu_torch.parallel import multihost as port_mh
from video_restore_tpu_torch.video.y4m import Y4MWriter

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 120  # seconds per subprocess


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**kw):
    env = dict(os.environ, OMP_NUM_THREADS="1", **kw)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return env


def _communicate(procs):
    """Each process's (rc, stdout, stderr), each waited for at most TIMEOUT
    seconds and killed after it."""
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
            pytest.fail(f"subprocess hung:\n{out[-2000:]}\n{err[-2000:]}")
        outs.append((p.returncode, out, err))
    return outs


@pytest.mark.parametrize("n", [0, 1, 5, 11])
def test_shard_items_match_jax(n):
    from video_restore_tpu.parallel.multihost import shard_items

    items = [f"v{i}" for i in range(n)]
    for nprocs in (1, 2, 3, 4):
        shares = [port_mh.shard_items(items, pid, nprocs) for pid in range(nprocs)]
        assert shares == [shard_items(items, pid, nprocs) for pid in range(nprocs)]
        assert sorted(x for s in shares for x in s) == sorted(items)
    # no group: this process is the only one
    assert port_mh.shard_items(items) == items


def test_allgather_counts_without_a_group_match_jax():
    from video_restore_tpu.parallel.multihost import allgather_counts

    assert port_mh.process_count() == 1 and port_mh.process_index() == 0
    assert port_mh.allgather_counts([3, 7]) == allgather_counts([3, 7]) == [[3, 7]]


_WORKER = r"""
import json, sys
import torch.distributed
from video_restore_tpu_torch.parallel.multihost import (
    allgather_counts, init_multihost, shard_items,
)

coord, pid = sys.argv[1], int(sys.argv[2])
init_multihost(coord, 2, pid)
items = [f"v{i}" for i in range(5)]
mine = shard_items(items)
rows = allgather_counts([len(mine), 7 + pid])
print("RESULT " + json.dumps({"pid": pid, "mine": mine, "rows": rows}))
torch.distributed.destroy_process_group()
"""


def test_two_process_group_shards_and_gathers(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, coord, str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=tmp_path, env=_env(), text=True,
        )
        for pid in range(2)
    ]
    by_pid = {}
    for rc, out, err in _communicate(procs):
        assert rc == 0, f"worker failed:\n{out}\n{err[-2000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][0]
        r = json.loads(line[len("RESULT "):])
        by_pid[r["pid"]] = r
    assert by_pid[0]["mine"] == ["v0", "v2", "v4"]
    assert by_pid[1]["mine"] == ["v1", "v3"]
    assert by_pid[0]["rows"] == by_pid[1]["rows"] == [[3, 7], [2, 8]]


def _clips(indir, n=4, h=16, w=24):
    indir.mkdir()
    for v in range(n):
        rng = np.random.default_rng(v)
        with Y4MWriter(indir / f"clip{v}.y4m", w, h, 25) as wr:
            for _ in range(2):
                wr.write(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def test_batch_multihost_two_processes_equal_one(tmp_path, monkeypatch):
    indir = tmp_path / "in"
    _clips(indir)
    flags = ["--batch", "--cpu", "--model", "RealESRGAN_x4_v3", "--models-dir", str(tmp_path / "m")]
    coord = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "video_restore_tpu_torch.cli", str(indir), str(tmp_path / "multi"),
             "--multihost", "--coordinator", coord] + flags,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=tmp_path, text=True,
            env=_env(WORLD_SIZE="2", RANK=str(rank), VRT_ALLOW_RANDOM_WEIGHTS="1"),
        )
        for rank in range(2)
    ]
    for rank, (rc, _, err) in enumerate(_communicate(procs)):
        assert rc == 0, err[-3000:]
        assert f"[batch] multihost: process {rank}/2 takes 2 of 4 videos" in err, err[-3000:]
        assert "batch complete: 4/4 succeeded" in err
    monkeypatch.setenv("VRT_ALLOW_RANDOM_WEIGHTS", "1")
    assert cli.main([str(indir), str(tmp_path / "one")] + flags) == 0
    names = sorted(p.name for p in (tmp_path / "one").iterdir())
    assert names == [f"clip{v}_upscaled.y4m" for v in range(4)]
    assert sorted(p.name for p in (tmp_path / "multi").iterdir()) == names
    for name in names:
        assert (tmp_path / "multi" / name).read_bytes() == (tmp_path / "one" / name).read_bytes(), name


def test_multihost_without_coordinator_exits_1(tmp_path, capsys, monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    src = tmp_path / "in.y4m"
    with Y4MWriter(src, 24, 16, 25) as wr:
        wr.write(np.zeros((16, 24, 3), np.uint8))
    assert cli.main([str(src), str(tmp_path / "o.y4m"), "--cpu", "--multihost"]) == 1
    assert "multihost init failed" in capsys.readouterr().err
    with pytest.raises(ValueError, match="no coordinator"):
        port_mh.init_multihost()
