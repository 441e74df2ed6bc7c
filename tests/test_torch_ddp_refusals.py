"""``python -m pq3d_tpu_torch.run`` refusals under two gloo ranks on the
CPU (through ``python -m pq3d_tpu_torch.launch``, the tiny stage-1 widths
of ``tests/test_torch_trainer.py``): the flat pack and a batch size (or
eval batch size) the world does not divide raise ``ValueError``, and so
do a ``parallel.tp`` and a ``parallel.data`` whose mesh does not make the
world; a preemption flag raised on rank 1 alone stops both
ranks after the same step, with ``latest`` saved; with
``dataloader.allow_single_device`` the flat pack trains on rank 0 alone
while rank 1 returns.
"""
import shutil

import torch

import _torch_ddp_worker as w
from test_torch_ddp_resume import ARGS
from test_torch_train_rng import _state, _train_records

torch.set_num_threads(1)


def test_refusals_preemption_and_single_device(tmp_path):
    try:
        _refusal_checks(tmp_path)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


def _refusal_checks(tmp_path):
    ranks = w.spawn("refusals", tmp_path, *ARGS, "solver.epochs=1")
    for rk in ranks:
        for name, kind in (("flat_pack", "ValueError"),
                           ("batchsize", "ValueError"),
                           ("batchsize_eval", "ValueError"),
                           ("tp", "ValueError"),
                           ("data", "ValueError")):
            assert rk[name] is not None and rk[name][0] == kind, \
                (name, rk[name])
        assert "allow_single_device" in rk["flat_pack"][1]
        # rank 1's flag stopped both after step 1 of 3 epochs
        assert rk["preempt"] == (1, 0, True)
    assert _state(str(tmp_path / "preempt"), "latest")["step"] == 1
    # flat pack with allow_single_device: rank 0 trained alone, rank 1 left
    assert ranks[0]["single"] == (1, 1, False)
    assert ranks[1]["single"] is None
    recs = _train_records(str(tmp_path / "single"))
    assert [r["step"] for r in recs] == [1]
