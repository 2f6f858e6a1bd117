"""lzhuf_pipeline stages hist (the c and p histograms and token counts)
and plan (the host LzhufPlan of each buffer), ms a request."""

from benchmark import readers


def read(rec):
    return readers.stage_ms(rec, ["hist", "plan"])
