"""Summed time of the kernels launched inside the span of the
deflate_pipeline stage screen, ms a request. Beside deflate.screen_ms,
the stage's time, it says whether the screen is device-bound (the two
close) or launch-bound (this one well below)."""

from benchmark import readers, spans


def read(rec):
    return spans.kernel_ms(rec, "deflate.screen", readers.ENCODE)
