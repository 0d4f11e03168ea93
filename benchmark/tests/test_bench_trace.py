"""The trace reduction on a hand-made chrome trace: the slice, device
busy time, each kernel tied to the range that launched it, the
breakdown, and the kernel readers' arithmetic."""

import pytest

from benchmark import readers, trace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def events():
    return [
        ev("user_annotation", trace.SLICE, 1000, 1000, tid=1),
        ev("user_annotation", "bench.windows n=1 B=1 K=5 P=4 cap=10 M=96", 1100, 500, tid=2),
        ev("user_annotation", "asr_dispatch", 1150, 400, tid=2),
        ev("cpu_op", "aten::mul", 1160, 10, tid=2),
        ev("cuda_runtime", "cudaLaunchKernel", 1170, 5, tid=2, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 1180, 5, tid=2, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 1190, 5, tid=2, corr=3),
        ev("kernel", "int8_product_kernel<3>", 1200, 100, corr=1),
        ev("kernel", "logits_topk_kernel", 1300, 50, corr=2),
        ev("kernel", "int8_product_kernel<3>", 1400, 100, corr=3),
        ev("kernel", "before_the_slice", 500, 100),
    ]


def test_parse_and_busy():
    tr = trace.parse(events())
    assert (tr.lo, tr.hi) == (1000, 2000)
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s() == pytest.approx(250e-6)
    disp = tr.ranges("asr_dispatch")[0]
    assert [o.name for o in tr.launched_in(disp)] == [
        "int8_product_kernel<3>", "logits_topk_kernel", "int8_product_kernel<3>"]
    assert trace.params(tr.ranges("bench.windows")[0].name) == {
        "n": 1, "B": 1, "K": 5, "P": 4, "cap": 10, "M": 96}


def test_breakdown_names_ops_and_host_activity():
    b = trace.parse(events()).breakdown()
    ops = dict(b["device_ops"])
    assert ops["int8_product_kernel<3>"] == pytest.approx(200e-6)
    idle = dict(b["idle_gaps"])
    assert sum(idle.values()) == pytest.approx(750e-6)
    # each gap goes to the innermost host range over its middle
    assert idle == pytest.approx({"bench.windows": 200e-6, "asr_dispatch": 50e-6,
                                  "no host range": 500e-6})


class _Run:
    def __init__(self, tr, config):
        self.trace, self.config = tr, config


def test_step_and_head_rooflines_from_shapes():
    tr = trace.parse(events())
    cfg = {"decoder_layers": 32, "d_model": 1280, "decoder_attention_heads": 20,
           "max_source_positions": 1500, "vocab_size": 51865}
    run = _Run(tr, cfg)
    share = readers.decode_step_roofline(run, ("int8_product_kernel",), ("logits_topk_kernel",))
    bound = readers.work.whisper_step_ms(L=32, D=1280, H=20, bk=5, n_seq=1, s_audio=1500,
                                         xa_elem=1, xa_scaled=True, picked=20,
                                         per_row_cols=5, sel_numel=5 * 128 * 5)
    assert share == pytest.approx(100 * bound / 1e3 / 200e-6)
    head = readers.head_roofline(run, ("logits_topk_kernel",))
    hb = readers.work.whisper_head_ms(V=51865, D=1280, bk=5, k=6, int8=True, grammar=False)
    assert head == pytest.approx(100 * hb / 1e3 / 50e-6)


def test_rooflines_count_the_real_rows():
    """A range of 6 windows in buckets of 4 runs 4 real rows, then 2 and 2
    rows of padding: the bounds count the rows that carry a window."""
    evs = [ev("user_annotation", trace.SLICE, 1000, 1000, tid=1),
           ev("user_annotation", "bench.windows n=6 B=4 K=3 P=4 cap=70 M=224", 1010, 900,
              tid=3)]
    for j, t0 in enumerate((1020, 1400)):
        evs += [ev("user_annotation", "asr_dispatch", t0, 300, tid=3),
                ev("cuda_runtime", "cudaLaunchKernel", t0 + 10, 5, tid=3, corr=10 + 2 * j),
                ev("cuda_runtime", "cudaLaunchKernel", t0 + 20, 5, tid=3, corr=11 + 2 * j),
                ev("kernel", "int8_product_kernel<3>", t0 + 30, 100, corr=10 + 2 * j),
                ev("kernel", "logits_topk_kernel", t0 + 140, 50, corr=11 + 2 * j)]
    cfg = {"decoder_layers": 32, "d_model": 1280, "decoder_attention_heads": 20,
           "max_source_positions": 1500, "vocab_size": 51865}
    run = _Run(trace.parse(evs), cfg)
    assert [rows for _, rows, _ in readers.asr_dispatches(run)] == [4, 2]
    step = sum(readers.work.whisper_step_ms(
        L=32, D=1280, H=20, bk=3 * n, n_seq=n, s_audio=1500, xa_elem=1, xa_scaled=True,
        picked=4 * 3 * n, per_row_cols=5, sel_numel=(3 * n) ** 2 * 256) for n in (4, 2))
    share = readers.decode_step_roofline(run, ("int8_product_kernel",), ("logits_topk_kernel",))
    assert share == pytest.approx(100 * step / 1e3 / 200e-6)
    head = sum(readers.work.whisper_head_ms(V=51865, D=1280, bk=3 * n, k=4, int8=True,
                                            grammar=False) for n in (4, 2))
    assert readers.head_roofline(run, ("logits_topk_kernel",)) == pytest.approx(
        100 * head / 1e3 / 100e-6)


def test_idle_share_inside_ranges():
    tr = trace.parse(events())
    run = _Run(tr, {})
    share = readers.idle_share(run, [(h.ts, h.te) for h in tr.ranges("asr_dispatch")])
    assert share == pytest.approx(100 * (1 - 250 / 400))


def test_missing_slice_is_an_error():
    with pytest.raises(RuntimeError):
        trace.parse([e for e in events() if e["name"] != trace.SLICE])
