"""A whole run of the harness on the CPU at the test size (the look for a
card skipped): its last line, and ``correct`` coming out false for the
control (the port's bf16 serving cast) and for each fault a serving cell
can have, planted under the timed path: an answer altered where it is
produced, the ranking altered, half of the batch left out, and the
decoder's attend masks ignored.  On a card (``-m cuda``) the control and
the ignored attend masks also run at the cell's own size, on three seeds
each."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

sys.path.insert(0, tiny.REPO)
from perfbench import run  # noqa: E402

ARGS = ["--workload", "tiny_serve", "--seconds", "6", "--trace", "0"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(str(tmp_path_factory.mktemp("bench")))


def last_line(root, capsys, seed, extra=()):
    assert run.main(ARGS + ["--seed", str(seed), *extra], root=root,
                    device="cpu") == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    return line, out.err


def test_a_sound_run(root, capsys):
    line, err = last_line(root, capsys, 2 ** 31 + 11)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "compared"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["metrics"]) == {"serve_requests_per_s", "serve_p95_s",
                                    "peak_mem_gib", "setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["compared"]) == {"logit_gap", "rank_mismatch"}
    assert err.strip().splitlines()[-1].startswith("compared rank_mismatch")


def test_a_traced_run(root, capsys):
    # a forward on the CPU can take seconds: a longer window holds both
    # traced windows
    assert run.main(["--workload", "tiny_serve", "--seconds", "16",
                     "--trace", "1", "--seed", "21"], root=root,
                    device="cpu") == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "compared"]
    assert line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # with no card nothing reads the device and no peak is known: the
    # server's stages remain
    assert set(line["metrics"]) == {"server.prep_ms_per_batch"}


def test_the_control_is_refused(root, capsys):
    line, _ = last_line(root, capsys, 7, ["--control", "bf16"])
    assert line["correct"] is False
    assert line["compared"]["logit_gap"]["value"] \
        > line["compared"]["logit_gap"]["limit"]


def _patch_forward(monkeypatch, change):
    from pq3d_tpu_torch.models import query3d
    orig = query3d.Query3DUnified.forward

    def forward(self, batch):
        out = orig(self, batch)
        change(out)
        return out
    monkeypatch.setattr(query3d.Query3DUnified, "forward", forward)


def test_an_altered_answer_is_refused(root, capsys, monkeypatch):
    def change(out):
        m = out["predictions_mask"][-1]
        out["predictions_mask"][-1] = m + 0.05 * m.abs().max()
    _patch_forward(monkeypatch, change)
    line, _ = last_line(root, capsys, 12)
    assert line["correct"] is False
    assert line["compared"]["logit_gap"]["value"] > 0.04


def test_an_altered_ranking_is_refused(root, capsys, monkeypatch):
    from pq3d_tpu_torch import serve
    orig = serve.rank_instances

    def rank(*a, **k):
        return orig(*a, **k)[1:]
    monkeypatch.setattr(serve, "rank_instances", rank)
    line, _ = last_line(root, capsys, 13)
    assert line["correct"] is False
    assert line["compared"]["rank_mismatch"]["value"] > 0


def test_half_the_batch_left_out_is_refused(root, capsys, monkeypatch):
    def change(out):
        for key in ("predictions_class", "predictions_mask"):
            for t in out[key]:
                h = t.shape[0] // 2
                t[h:2 * h] = t[:h].clone()
    _patch_forward(monkeypatch, change)
    line, _ = last_line(root, capsys, 14)
    assert line["correct"] is False


def test_no_card_no_result(tmp_path):
    """``python3 perfbench/run.py`` where the program is absent, or no
    card is there: exit non-zero, no line."""
    root = tiny.tiny_root(str(tmp_path))
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "perfbench", "run.py")]
        + ARGS + ["--seed", "1"], cwd=root, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode != 0
    assert not proc.stdout.strip()


def _ignore_attend_masks(monkeypatch):
    """The decoder attends every real segment whatever its mask logits
    say: ``use_self_mask`` switched off under the timed path."""
    from pq3d_tpu_torch.models import query_encoder
    orig = query_encoder.QueryMaskEncoder.forward

    def forward(self, *a, **k):
        self.use_self_mask = False
        return orig(self, *a, **k)
    monkeypatch.setattr(query_encoder.QueryMaskEncoder, "forward", forward)


def test_the_attend_masks_ignored_are_refused(root, capsys, monkeypatch):
    _ignore_attend_masks(monkeypatch)
    line, err = last_line(root, capsys, 15)
    assert line["correct"] is False
    assert line["compared"]["logit_gap"]["value"] > 0.04
    share = float(err.split("false attend bits ")[1].split()[0])
    assert 0.1 < share < 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [7, 2 ** 31 + 5, 2 ** 31 + 6])
@pytest.mark.parametrize("fault", ["control", "attend"])
def test_refused_at_the_cell_size(fault, seed, capsys, monkeypatch):
    """The control (the port's bf16 cast) and the attend masks ignored,
    each at the cell's own size and load."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    extra = []
    if fault == "control":
        extra = ["--control", "bf16"]
    else:
        _ignore_attend_masks(monkeypatch)
    assert run.main(["--workload", "s1_serve_dev_maps", "--seed", str(seed),
                     "--seconds", "20", "--trace", "0", *extra]) == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    with capsys.disabled():
        print(f"\n{fault} seed {seed}: {line['compared']} "
              f"{[x for x in out.err.splitlines() if 'window' in x]}")
    assert line["correct"] is False
