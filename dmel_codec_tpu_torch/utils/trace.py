"""Spans at the port's layer boundaries, for a profiler that is recording.

`span(name)` is the one way the program marks a layer on a profiler's
timeline. While a profiler records (`torch.autograd._profiler_enabled()`),
it is `torch.profiler.record_function(name)`: a user annotation on the
profiler's clock, the clock of the device's events, so a reader of the
trace can put each device operation and each idle gap under the innermost
span open on the host. Otherwise it is one shared null context: a span
then costs the check and creates no `RecordFunction`.

Names are dotted, the layer first: `codec.encode.wavenet`, `vocoder.s3`,
`lm.prefill`, `train.update.clip`, `codec.train.preamble`.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks `name` on a recording profiler's
    timeline, and the shared null context when none records. Decided on
    each call: a span made before a profiler starts records nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
