"""mla_attend_ms.dialog on hand-built traces: the device time under the
program's span `lm.mla.attend` (and nothing under its parent `lm.mla`
beside it) a traced batch, and None where the trace has no such span."""

import pytest

from benchmark.harness import spec
from benchmark.tests.test_span_metrics import SERVE, run, trace

# a prefill: two layers' latent attention, each its projections under lm.mla around the core under lm.mla.attend
DIALOG = trace(
    [("lm.prefill", 0, 60), ("lm.mla", 2, 20), ("lm.mla.attend", 5, 15), ("lm.mla", 30, 50),
     ("lm.mla.attend", 33, 45), ("lm.moe.experts", 50, 58)],
    [(3, 4, "lm.mla", True), (6, 9, "lm.mla.attend", True), (10, 14, "lm.mla.attend", True),
     (16, 18, "lm.mla", True), (34, 40, "lm.mla.attend", True), (51, 57, "lm.moe.experts", True)])


@pytest.mark.parametrize("traced", [1, 2])
def test_reads_the_core_a_traced_batch(traced):
    assert spec.reader("mla_attend_ms.dialog")(run(DIALOG, traced)) == pytest.approx((3 + 4 + 6) / traced)


def test_none_without_the_span():
    read = spec.reader("mla_attend_ms.dialog")
    assert read(run(SERVE, 1)) is None
    assert read(run(None, 1)) is None
