"""The port's multi-process dryrun and graft stages, on CPU.

``run_multiprocess_dryrun(2, 2)`` spawns 2 hosts x 2 devices as 4 gloo
ranks on ``torch.distributed`` and checks that the source-sharded batched
step with the cross-process mixdown matches an unsharded render (the
worker asserts it; the run raises on any rank's failure), as
tests/test_multihost.py does for the JAX package.  The graft's ``entry()``
is held to ``__graft_entry__.entry()`` (5e-7), and ``dryrun_multichip(4)``
runs stages (a)-(f) in 4 ranks.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jefferson_tpu_torch import graft
from jefferson_tpu_torch.parallel.multihost import run_multiprocess_dryrun

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

torch.set_num_threads(1)

TOL_JAX = 5e-7


@pytest.fixture(autouse=True)
def one_thread_ranks(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_multiprocess_dryrun_2x2(capsys):
    run_multiprocess_dryrun(num_processes=2, local_devices=2, timeout=240.0, device="cpu")
    line = capsys.readouterr().out
    assert "[multihost] 2 processes x 2 devices (4 ranks, gloo on cpu)" in line
    assert "collectives {'mix_all_reduce': 1, 'gather_rows': 0} OK" in line


def test_multiprocess_dryrun_raises_on_a_failed_rank(monkeypatch):
    """A rank that cannot start fails the run, with every rank's output."""
    monkeypatch.setattr("jefferson_tpu_torch.parallel.multihost.WORKER",
                        "jefferson_tpu_torch.no_such_worker")
    with pytest.raises(RuntimeError, match="(?s)multi-process dryrun failed.*No module named"):
        run_multiprocess_dryrun(num_processes=2, local_devices=1, timeout=60.0, device="cpu")


def test_graft_entry_matches_jax():
    import jax

    import __graft_entry__ as g

    fn, args = graft.entry("cpu")
    out, hists = fn(*args)
    assert tuple(out.shape) == (4, 16, 128, 2) and np.isfinite(out.numpy()).all()
    jfn, jargs = g.entry()
    want, want_hists = jax.jit(jfn)(*jargs)
    assert np.abs(out.numpy() - np.asarray(want)).max() <= TOL_JAX
    np.testing.assert_array_equal(hists.numpy(), np.asarray(want_hists))


def test_graft_dryrun_multichip(capsys):
    graft.dryrun_multichip(4, device="cpu", timeout=300.0)
    out = capsys.readouterr().out
    for line in ("dryrun 1-D OK: 8 sources sharded over 4 ranks",
                 "dryrun 2-D OK: (4 src x 4 blk) over a 2x2 ('src','blk') mesh",
                 "dryrun (c) OK: 8 sources through the fused (onehot_shared) arm",
                 "dryrun (d) OK: 8 sources through the dedup+fused",
                 "dryrun CLI OK: `--scene --devices 4` (src mesh) and `-i --devices 4`",
                 "[multihost] 2 processes x 2 devices",
                 "dryrun multi-process OK"):
        assert line in out, line
    # each stage's collectives: (a) a mixdown and a gather, (b) one
    # all-reduce over 'src' and three gathers, (c)/(d) one gather a chunk
    assert "collectives {'mix_all_reduce': 1, 'gather_rows': 1}" in out
    assert "collectives {'mix_all_reduce': 1, 'gather_rows': 3}" in out
    assert os.linesep.join(out.splitlines()).count("OK") >= 7
