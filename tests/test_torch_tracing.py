"""The port's recorder of spans and counters (pq3d_tpu_torch/utils/
profiling.py) in the stage-1 server and forward, on the CPU at test size:
nothing is recorded without a profiler while the server's stage sums are
kept; under one, every batch has its five server spans with batch and
request ids, the forward's three spans under its dispatch, each request's
queue wait and each batch's hold; the host spans are host events of the
profiler and no span is a device event; a second profiler starts a second
session; and torch.export traces through the spans as if they were not
there."""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pq3d_tpu_torch.data import synthetic
from pq3d_tpu_torch.data.instseg_pipeline import InstSegPipelineConfig
from pq3d_tpu_torch.models import query3d as tq3d
from pq3d_tpu_torch.serve import InstSegServer
from pq3d_tpu_torch.utils import profiling

torch.set_num_threads(1)

SERVER_SPANS = ("server.preprocess", "server.collate", "server.dispatch",
                "server.readback", "server.rank")
MODEL_SPANS = ("model.maps", "model.backbone", "model.decoder")
HOST_SPANS = ("server.preprocess", "server.collate", "server.rank")
STAGES = {"preprocess", "collate", "put_dispatch", "readback", "rank"}


@pytest.fixture(scope="module")
def served():
    """A test-size stage-1 model, its pipeline and three scenes."""
    rng = np.random.default_rng(0)
    pipe = InstSegPipelineConfig(
        voxel_size=0.15, num_queries=8, max_segments=32, max_instances=8,
        voxel_bucket=128, use_aug=False, stem_mode="dense_block",
        level_caps=[512, 256, 128, 128, 128])
    scenes = [synthetic.make_scene(rng, n_points=n, n_instances=3,
                                   n_segments=16) for n in (600, 900, 700)]
    model = tq3d.Query3DUnified(
        memories=("voxel",), heads=("mask",), hidden_size=32, dim_loc=3,
        unified=tq3d.UnifiedEncoderCfg(num_layers=1, num_blocks=1,
                                       num_attention_heads=4,
                                       use_self_mask=True),
        voxel_enc=tq3d.VoxelEncoderCfg(hlevels=(0, 1), out_channels=20),
        mask_head_cfg=tq3d.MaskHeadCfg(21, (0, 2)))
    tq3d.init_weights(model, torch.Generator().manual_seed(0))
    model.eval()
    return model, pipe, scenes


class _ProfiledServer(InstSegServer):
    """A CPU profiler on the server's thread (a profiler records the host
    operators of the thread that starts it, and stops there): started
    as the server first looks for requests, stopped when the batch that
    holds request ``last`` has finished."""

    prof = None
    last = 2

    def _collect(self, first_timeout=None):
        if self.prof is None:
            self.prof = profile(activities=[ProfilerActivity.CPU])
            self.prof.start()
        return super()._collect(first_timeout)

    def _finish(self, state, ids):
        out = super()._finish(state, ids)
        if self.last in ids["requests"]:
            self.prof.stop()
        return out


def serve(served, traced: bool):
    """Serve the three scenes one at a time in two batches (2 + 1), under
    a CPU profiler started on the server's thread when ``traced``;
    returns (server stats, the submit bounds in ns by request id, the
    stopped profiler or None)."""
    model, pipe, scenes = served
    profiling.clear()
    cls = _ProfiledServer if traced else InstSegServer
    srv = cls(model, pipe, batch_size=2, num_classes=20, topk=10,
              max_delay_s=0.5, device="cpu")
    submitted = {}
    try:
        futs = []
        for rid, s in enumerate(scenes):
            t0 = time.time_ns()
            futs.append(srv.submit(s))
            submitted[rid] = (t0, time.time_ns())
        for f in futs:
            assert isinstance(f.result(timeout=300), list)
    finally:
        srv.close()
    return srv.stats, submitted, getattr(srv, "prof", None)


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_no_profiler_records_nothing_and_keeps_the_stage_sums(served):
    stats, _, _ = serve(served, traced=False)
    assert profiling.sessions() == {}
    assert stats.steps == 2 and stats.scenes == 3
    assert set(stats.stage_s) == STAGES
    assert all(v > 0 for v in stats.stage_s.values())
    assert not hasattr(stats, "total_wait_s")
    assert not hasattr(stats, "total_step_s")
    assert profiling.span("x") is profiling.device_span("y", "cpu")


def test_server_spans_ids_parents_waits_and_holds(served):
    stats, submitted, _ = serve(served, traced=True)
    assert set(stats.stage_s) == STAGES
    sessions = profiling.sessions()
    assert list(sessions) == [1]
    spans = sessions[1]
    batches = {0: (0, 1), 1: (2,)}
    for name in SERVER_SPANS:
        got = _by_name(spans, name)
        assert [(s.ids["batch"], s.ids["requests"]) for s in got] \
            == list(batches.items()), name
        for s in got:
            assert s.parent is None and s.end_ns >= s.start_ns > 0
            assert s.device_ms is None
    disp = {s.ids["batch"]: s for s in _by_name(spans, "server.dispatch")}
    disp_ids = {s.id: s for s in disp.values()}
    for name in MODEL_SPANS:
        got = _by_name(spans, name)
        assert len(got) == 2, name
        for s in got:
            d = disp_ids[s.parent]
            assert d.start_ns <= s.start_ns <= s.end_ns <= d.end_ns
    # the stages of a batch in order on the server's thread
    thread = {s.thread for s in spans if s.name.startswith("server.")}
    assert len(thread) == 1
    for b in batches:
        ends = [_by_name(spans, n)[b] for n in SERVER_SPANS]
        for a, c in zip(ends, ends[1:]):
            assert a.end_ns <= c.start_ns

    prep = {s.ids["batch"]: s for s in _by_name(spans, "server.preprocess")}
    waits = _by_name(spans, "server.queue_wait")
    assert sorted(s.ids["request"] for s in waits) == [0, 1, 2]
    for s in waits:
        lo, hi = submitted[s.ids["request"]]
        start = prep[s.ids["batch"]].start_ns
        assert s.ids["request"] in batches[s.ids["batch"]]
        # stamped as the server takes the batch, before its host work
        assert s.start_ns == s.end_ns <= start
        assert (s.start_ns - hi) * 1e-9 - 1e-3 <= s.value \
            <= (s.start_ns - lo) * 1e-9
    read = {s.ids["batch"]: s for s in _by_name(spans, "server.readback")}
    holds = _by_name(spans, "server.hold")
    assert sorted(s.ids["batch"] for s in holds) == [0, 1]
    for s in holds:
        # stamped as the batch's readback starts
        assert disp[s.ids["batch"]].end_ns <= s.start_ns \
            <= read[s.ids["batch"]].start_ns
        want = (s.start_ns - disp[s.ids["batch"]].end_ns) * 1e-9
        assert s.value > 0 and abs(s.value - want) <= 1e-3


def test_host_spans_are_host_events_and_no_span_a_device_event(served):
    _, _, prof = serve(served, traced=True)
    events = prof.events()
    names = [e.name for e in events]
    for name in HOST_SPANS:
        assert names.count(name) == 2, name
    for name in ("server.dispatch", "server.readback") + MODEL_SPANS:
        assert name not in names, name
    spans = set(SERVER_SPANS + MODEL_SPANS)
    cpu = torch.autograd.DeviceType.CPU
    assert not [e.name for e in events
                if e.device_type != cpu and e.name in spans]
    assert all(e.device_type == cpu for e in events
               if e.name in HOST_SPANS)


def test_a_second_profiler_starts_a_second_session():
    profiling.clear()
    for _ in range(2):
        with profiling.span("outside"):
            pass
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span("a", batch=1) as a:
                profiling.count("c", 2.5, request=3)
                with profiling.device_span("b", "cpu"):
                    pass
            assert a.end_ns >= a.start_ns
    sessions = profiling.sessions()
    assert list(sessions) == [1, 2]
    for spans in sessions.values():
        a, c, b = spans
        assert [s.name for s in spans] == ["a", "c", "b"]
        assert c.parent == a.id and b.parent == a.id and a.parent is None
        assert c.value == 2.5 and c.ids == {"request": 3}
        assert a.ids == {"batch": 1}
    assert sessions[2][0].id > sessions[1][-1].id


def test_the_buffer_is_bounded():
    rec = profiling.Recorder(limit=3)
    for i in range(5):
        rec.add(profiling.Span(str(i), {}, 1))
    assert [s.name for s in rec.sessions()[1]] == ["2", "3", "4"]


class _Spanned(torch.nn.Module):
    def forward(self, x):
        with profiling.device_span("model.maps", x.device):
            y = x * 2
        with profiling.span("server.rank"):
            return y + 1


def test_export_traces_through_the_spans():
    x = torch.randn(3)
    plain = torch.export.export(_Spanned(), (x,), strict=False)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = torch.export.export(_Spanned(), (x,), strict=False)
    assert profiling.sessions() == {}
    ops = [str(n.target) for n in traced.graph.nodes]
    assert ops == [str(n.target) for n in plain.graph.nodes]
    assert not [o for o in ops if "profiler" in o or "record" in o]
    torch.testing.assert_close(traced.module()(x), x * 2 + 1)
