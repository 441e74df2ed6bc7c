"""The program's spans on the device-only window's clock
(``perfbench/spans.py``) and the nine readers of them: nothing on an
empty context, on a program without the recorder or on a window with no
copy to match; on a planted window of two batches, the window's start
recovered to under 1 ms from the readbacks' copies past a decoy copy, the
residual, and each reader's hand-computed value, the idle trio summing to
the window's idle share; a clock rate fitted where the readbacks drift
from the copies; the host window's gaps printed with their times and
the spans around them, and the untraced dispatch beside the traced."""
from __future__ import annotations

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from perfbench import run, spans  # noqa: E402
from perfbench.trace import Trace  # noqa: E402
from pq3d_tpu_torch.utils import profiling  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
READERS = ("server.queue_wait_ms.serve", "server.hold_ms_per_batch.serve",
           "server.rank_ms_per_batch.serve", "device.idle_in_dispatch.serve",
           "device.idle_in_host_work.serve", "device.idle_elsewhere.serve",
           "model.maps_ms.serve", "model.backbone_ms.serve",
           "model.decoder_ms.serve")
START_NS = 1_792_000_000_123_456_789     # the window's start, Unix ns
LAGS = (1e-4, 3e-4)                      # readback end after its copy


def reader(name):
    return run.load_module(os.path.join(REPO, "perfbench", "metrics",
                                        name + ".py"), "m_" + name)


def fake(name, a, b=None, value=None, ms=None, session=1, **ids):
    """A recorded span from ``a`` to ``b`` seconds of the window."""
    b = a if b is None else b
    return SimpleNamespace(
        name=name, start_ns=START_NS + round(a * 1e9),
        end_ns=START_NS + round(b * 1e9), ids=ids, value=value,
        device_ms=ms, parent=None, session=session, thread=1)


def planted():
    """(sessions, trace): two batches a second apart in a 2-s window.
    In each second: preprocess 0.10-0.30, collate -0.35, dispatch -0.55
    (the forward's three spans inside it), readback 0.80 to its last copy's
    end plus its lag, rank 0.851-0.95; kernels 0.37-0.45 and 0.47-0.60, a
    decoy DtoH copy inside the first, the readback's copies 0.8485-0.8490
    and 0.8495-0.8498."""
    first, device = [], []
    waits = {0: (0.010, 0.020), 1: (0.004, 0.006)}
    maps, back, dec = (4.0, 6.0), (80.0, 82.0), (60.0, None)
    for b in (0, 1):
        t, req = float(b), (2 * b, 2 * b + 1)
        for r, w in zip(req, waits[b]):
            first.append(fake("server.queue_wait", t + 0.1, value=w,
                              batch=b, request=r))
        first += [fake("server.preprocess", t + 0.10, t + 0.30, batch=b,
                       requests=req),
                  fake("server.collate", t + 0.30, t + 0.35, batch=b,
                       requests=req),
                  fake("server.dispatch", t + 0.35, t + 0.55, batch=b,
                       requests=req),
                  fake("model.maps", t + 0.36, t + 0.40, ms=maps[b]),
                  fake("model.backbone", t + 0.40, t + 0.48, ms=back[b]),
                  fake("model.decoder", t + 0.48, t + 0.54, ms=dec[b]),
                  fake("server.hold", t + 0.80, value=0.25, batch=b),
                  fake("server.readback", t + 0.80, t + 0.8498 + LAGS[b],
                       batch=b, requests=req),
                  fake("server.rank", t + 0.851, t + 0.95, batch=b,
                       requests=req)]
        device += [("kernel", t + 0.37, t + 0.45),
                   ("Memcpy DtoH (Device -> Pageable)", t + 0.40,
                    t + 0.401),
                   ("kernel", t + 0.47, t + 0.60),
                   ("Memcpy DtoH (Device -> Pageable)", t + 0.8485,
                    t + 0.8490),
                   ("Memcpy DtoH (Device -> Pageable)", t + 0.8495,
                    t + 0.8498)]
    # a batch dispatched before the window: its hold is not the window's
    first.insert(0, fake("server.hold", 0.05, value=0.9, batch=-1))
    later = [fake("server.rank", 5.0, 5.5, session=2, batch=9)]
    return {1: first, 2: later}, Trace(device=device, start=0.0, end=2.0)


@pytest.fixture
def ctx(monkeypatch):
    sessions, tr = planted()
    monkeypatch.setattr(profiling, "sessions", lambda: sessions)
    return {"trace": tr}


@pytest.mark.parametrize("name", READERS)
def test_readers_give_nothing_on_an_empty_context(name):
    assert reader(name).read({}) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_give_nothing_without_the_recorder(name, monkeypatch):
    _, tr = planted()
    monkeypatch.delattr(profiling, "sessions")
    assert reader(name).read({"trace": tr}) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_give_nothing_without_a_copy_to_match(name, ctx):
    tr = ctx["trace"]
    tr.device = [d for d in tr.device if not d[0].startswith("Memcpy")]
    assert reader(name).read(ctx) is None


def test_the_window_start_recovered_from_the_readbacks(ctx, capsys):
    ws = spans.window_spans(ctx)
    assert ws["matched"] == ws["readbacks"] == 2
    # the smaller lag is taken as 0
    assert abs(ws["offset_ns"] - START_NS) < 1e6
    assert ws["offset_ns"] - START_NS == pytest.approx(LAGS[0] * 1e9,
                                                       abs=2)
    assert ws["residual_ms"] == pytest.approx((LAGS[1] - LAGS[0]) * 1e3,
                                              abs=1e-6)
    assert "2 of 2 readbacks matched" in capsys.readouterr().err
    assert spans.window_spans(ctx) is ws
    # session 2 is not the window's
    assert all(s["ids"].get("batch") != 9 for s in ws["spans"])


def test_the_readers_hand_computed(ctx):
    got = {n: reader(n).read(ctx) for n in READERS}
    # idle a second: 1 - (0.08 + 0.13 + 0.0005 + 0.0003); in dispatch
    # 0.35-0.37 and 0.45-0.47; in host work the preprocess, collate, the
    # readback's 0.80-0.8485, 0.8490-0.8495 and its lag, the rank
    dispatch = 2 * 0.04
    host = 2 * (0.20 + 0.05 + 0.0485 + 0.0005 + 0.099) + sum(LAGS)
    idle = 2 * (1 - 0.2108)
    # the recovered clock puts the spans LAGS[0] early (the smaller lag
    # is taken as 0): the split moves by a few LAGS[0] at most
    want = {"device.idle_in_dispatch.serve": 50 * dispatch,
            "device.idle_in_host_work.serve": 50 * host,
            "device.idle_elsewhere.serve": 50 * (idle - dispatch - host)}
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=0.05), k
    trio = sum(got[k] for k in want)
    idle_share = reader("device.idle_share.serve").read(ctx)
    assert trio == pytest.approx(idle_share, abs=1e-9)
    assert idle_share == pytest.approx(50 * idle, abs=1e-9)
    assert got["server.queue_wait_ms.serve"] == pytest.approx(10.0)
    assert got["server.hold_ms_per_batch.serve"] == pytest.approx(250.0)
    assert got["server.rank_ms_per_batch.serve"] == pytest.approx(
        99.0, abs=1e-3)
    assert got["model.maps_ms.serve"] == pytest.approx(5.0)
    assert got["model.backbone_ms.serve"] == pytest.approx(81.0)
    assert got["model.decoder_ms.serve"] == pytest.approx(60.0)


def test_align_takes_the_offset_that_matches_the_most():
    copies = [1.0, 2.0, 3.0, 3.5]
    reads = [10.0003, 11.0001, 12.0002, 20.0]
    off, rate, gaps = spans.align(reads, copies)
    # three matched: too few to fit a rate
    assert off == pytest.approx(9.0001) and rate == 0.0
    assert sorted(round(g * 1e4) for g in gaps) == [0, 1, 2]
    assert spans.align([], copies) is None
    assert spans.align(reads, []) is None


def test_align_fits_a_clock_that_drifts(monkeypatch):
    """16 readbacks about 0.62 s apart (the host's jitter 0-50 ms) whose
    clock runs 1.5e-4 fast against the copies' (1.5 ms over the window,
    past the 1-ms match), each ending 0.1-0.2 ms after its copy, with a
    decoy copy 50 ms before each."""
    rng = np.random.default_rng(3)
    skew, lag = 1.5e-4, rng.uniform(1e-4, 2e-4, 16)
    copies = 0.3 + 0.62 * np.arange(16) + rng.uniform(0, 0.05, 16)
    reads = 5.0 + copies * (1 + skew) + lag
    every = np.sort(np.concatenate([copies, copies - 0.05]))
    off, rate, gaps = spans.align(list(reads), list(every))
    assert len(gaps) == 16
    assert rate == pytest.approx(skew / (1 + skew), abs=2e-5)
    # on the fitted clock each readback lies on its own copy
    on = reads - off - rate * reads
    assert np.all((on - copies >= -1e-9) & (on - copies <= 2e-4))
    assert max(gaps) - min(gaps) <= 1.2e-4
    # the offset alone matches only a part
    monkeypatch.setattr(spans, "FIT_MIN", 10 ** 9)
    assert len(spans.align(list(reads), list(every))[2]) < 16


def test_host_gaps_and_the_untraced_dispatch_printed(ctx, capsys,
                                                     monkeypatch):
    """The host window (its own clock): a 0.3-s gap inside a rank whose
    record_function the second session's span lies on, a 0.1-s gap in
    no operator; the untraced dispatch: 7 batches of 150 ms beside the
    three 200-ms traced ones."""
    th = Trace(device=[("kernel", 0.0, 0.2), ("kernel", 0.5, 0.6),
                       ("kernel", 0.7, 1.0)],
               host=[("server.rank", 0.1, 0.55, []),
                     ("aten::add", 0.3, 0.4, [])],
               start=0.0, end=1.0)
    sessions = {1: profiling.sessions()[1],
                2: [fake("server.rank", 4.1, 4.55, session=2, batch=7),
                    fake("server.dispatch", 4.55, 4.75, session=2,
                         batch=8)]}
    monkeypatch.setattr(profiling, "sessions", lambda: sessions)
    ctx.update(trace_host=th, stages={"put_dispatch": 1.65}, steps=10)
    spans.window_spans(ctx)
    err = capsys.readouterr().err
    assert ("host window gap 1: 0.2000-0.5000 s (0.3000 s), label "
            "aten::add 0.3000-0.4000") in err
    assert "spans at its middle [server.rank 0.1000-0.5500 (batch 7)]" \
        in err
    assert ("host window gap 2: 0.6000-0.7000 s (0.1000 s), label no "
            "operator (Python on the host)") in err
    assert ("untraced (stage_s outside the traced windows, 7 batches) "
            "150.000 ms, in the device-only window 200.000 ms, traced / "
            "untraced 1.3333") in err

