"""The program's own spans (``tpl.*``, ``observability.trace``) in a traced
stretch leave every accepted reading as it was: the host spans are not
``bench.*`` spans, and the device's copies of them are user annotations,
which ``reduce_profile`` skips. Only the names of the idle gaps change:
the program's spans now say what the host was doing."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from h100_bench import harness, trace
from h100_bench.tests.test_h100_bench_yardstick import _Ctx, _raw

#: the program's spans in the two solves of ``_raw``: a fused solve (K2,
#: getrf, K3) and a generic one (three products)
TPL = [("tpl.solve", 0.5, 60.0), ("tpl.pass_one", 0.8, 45.0),
       ("tpl.f_tk", 45.0, 52.5), ("tpl.pass_two", 52.5, 60.0),
       ("tpl.solve", 200.5, 208.0), ("tpl.pass_one", 200.6, 204.5),
       ("tpl.spmv", 201.2, 201.9), ("tpl.spmv", 203.2, 203.9),
       ("tpl.f_tk", 204.5, 205.5), ("tpl.pass_two", 205.5, 208.0),
       ("tpl.spmv", 206.2, 206.9)]


def _event(name, start, end, ident, link, device, annotation=False):
    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, id=ident, linked_correlation_id=link,
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        is_user_annotation=annotation,
        time_range=SimpleNamespace(start=start, end=end))


def _profile(with_program_spans: bool):
    dev, host = _raw()
    events = [_event(*row, device=False) for row in host]
    events += [_event(*row, device=True, annotation=row[0].startswith(
        trace.SPAN_PREFIX)) for row in dev]
    if with_program_spans:
        for i, (name, s, e) in enumerate(TPL):
            events.append(_event(name, s, e, 900 + i, 0, device=False,
                                 annotation=True))
            # the device's copy: from its first kernel to its last
            events.append(_event(name, s + 0.2, e + 0.1, 0, 0, device=True,
                                 annotation=True))
    return SimpleNamespace(events=lambda: events)


def _readings(stretch):
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    peak = {"f32_flops": 1e12, "hbm_bytes_per_s": 1e12}
    out = {}
    for i, method in ((0, "two_pass"), (1, "two_pass"), (0, "one_pass")):
        one = trace.Stretch([stretch.solves[i]], stretch.spans, 100.0,
                            stretch.busy_us / 2, {})
        ctx = _Ctx(one, {"method": method}, [7], peak,
                   {"kkt_matvec_in_pass": 999})
        for metric in spec["per_layer"]:
            out[(i, method, metric["name"])] = harness.module(
                "metrics", metric["name"]).read(ctx)
    return out


def test_every_accepted_reading_is_unmoved_by_the_programs_spans():
    before = trace.reduce_profile(_profile(False))
    after = trace.reduce_profile(_profile(True))
    assert after.solves == before.solves
    assert after.spans == before.spans
    assert (after.window_us, after.busy_us) == (before.window_us,
                                                before.busy_us)
    assert after.breakdown["device_ops"] == before.breakdown["device_ops"]
    got, want = _readings(after), _readings(before)
    assert got == want
    assert any(v is not None for v in want.values())


def test_the_idle_gaps_are_named_by_the_programs_spans():
    before = trace.reduce_profile(_profile(False)).breakdown["idle_gaps"]
    after = trace.reduce_profile(_profile(True)).breakdown["idle_gaps"]
    assert [s for _, s in after] == pytest.approx([s for _, s in before])
    # the gap between K2's end (40) and getrf's start (50.9) was the
    # harness's solve span's; now f(T_k)'s. The longest, [90, 100], follows
    # pass two's span: the harness's synchronise, named as before
    assert before[1][0] == "host: bench.solve"
    assert after[1][0] == "host: tpl.f_tk"
    assert [g for i, g in enumerate(after) if i != 1] == [
        g for i, g in enumerate(before) if i != 1]
