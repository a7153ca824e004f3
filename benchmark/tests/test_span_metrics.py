"""The readers of the program's spans, on hand-built traces: spans, device
operations and idle gaps laid out in milliseconds, each expected value
worked out by hand from where each gap's middle falls, and None where the
spans a reader needs are absent."""

import pytest

from benchmark.harness import spec
from benchmark.harness.runner import Run
from benchmark.harness.trace import DeviceOp, TraceData, _parents

MS = 1_000_000  # ns


def trace(spans, ops, window=(0, 100)) -> TraceData:
    """spans: (name, start ms, end ms); ops: (start ms, end ms, span, kernel)."""
    spans = sorted(((n, a * MS, b * MS) for n, a, b in spans), key=lambda s: s[1])
    return TraceData(windows=[(window[0] * MS, window[1] * MS)],
                     ops=[DeviceOp("op", a * MS, b * MS, sp, k) for a, b, sp, k in ops],
                     spans=spans, unlinked=0, parents=_parents(spans))


def run(td, traced: int) -> Run:
    return Run(cell=None, records=[{"traced": True} for _ in range(traced)] + [{}], window_s=1.0, setup_s=0.0,
               trace=td, power_limit_w=None)


# a request: the driver's spans around the program's (codec.encode twice, nested), then the vocoder
CODEC = trace(
    [("request", 0, 100), ("codec.mel", 2, 10), ("codec.encode", 10, 60), ("codec.encode", 11, 59),
     ("codec.encode.wavenet", 12, 40), ("codec.encode.fsq", 40, 58), ("vocoder.s0", 70, 90)],
    [(3, 8, "codec.mel", True), (14, 20, "codec.encode.wavenet", True), (25, 38, "codec.encode.wavenet", True),
     (42, 50, "codec.encode.fsq", True), (51, 52, "codec.encode.fsq", False), (61, 65, "request", False),
     (72, 88, "vocoder.s0", True), (89, 95, "vocoder.s0", True)])
# gaps by their middles: [0, 3] request 3; [8, 14] codec.encode 6; [20, 25] wavenet 5; [38, 42] fsq 4;
# [50, 51] fsq 1; [52, 61] fsq 9; [65, 72] request 7; [88, 89] vocoder.s0 1; [95, 100] request 5

# a batch: the prefill, one traced replay, the render
SERVE = trace(
    [("lm.prefill", 0, 30), ("lm.replay", 40, 50), ("render", 60, 100), ("codec.decode", 62, 80)],
    [(5, 10, "lm.prefill", True), (20, 25, "lm.prefill", True), (41, 49, "lm.replay", True),
     (63, 79, "codec.decode", True)])
# gaps: [0, 5] lm.prefill 5; [10, 20] lm.prefill 10; [25, 41] no span 16; [49, 63] no span 14; [79, 100] render 21

# a micro-step: the driver's train.step around the trainer's and the optimizer's spans
TRAIN = trace(
    [("train.step", 0, 100), ("train.loss_and_grads", 1, 60), ("train.metrics", 60, 70), ("train.update", 70, 99),
     ("train.update.guard", 71, 75), ("train.update.clip", 80, 90)],
    [(2, 58, "train.loss_and_grads", True), (61, 62, "train.metrics", True), (66, 72, "train.metrics", True),
     (76, 79, "train.update", True), (91, 98, "train.update", True)])
# gaps: [0, 2] train.step 2; [58, 61] loss_and_grads 3; [62, 66] metrics 4; [72, 76] guard 4;
# [79, 91] clip 12; [98, 100] train.update 2


@pytest.mark.parametrize("metric,td,traced,want", [
    ("codec_idle_ms.single", CODEC, 2, (6 + 5 + 4 + 1 + 9) / 2),
    ("codec_launches.single", CODEC, 2, 4 / 2),  # kernels only: the memcpy under codec.encode.fsq is not one
    ("prefill_idle_ms.serve", SERVE, 1, 5 + 10),
    ("update_idle_ms.train", TRAIN, 2, (4 + 12 + 2) / 2),
], ids=lambda v: v if isinstance(v, str) else "")
def test_reader_by_hand(metric, td, traced, want):
    assert spec.reader(metric)(run(td, traced)) == pytest.approx(want)


@pytest.mark.parametrize("metric,td", [
    ("codec_idle_ms.single", TRAIN),
    ("codec_launches.single", TRAIN),
    ("prefill_idle_ms.serve", CODEC),
    ("update_idle_ms.train", trace([("train.step", 0, 100)], [(2, 58, "train.step", True)])),
], ids=lambda v: v if isinstance(v, str) else "")
def test_reader_without_its_spans(metric, td):
    read = spec.reader(metric)
    assert read(run(td, 2)) is None
    assert read(run(None, 2)) is None
