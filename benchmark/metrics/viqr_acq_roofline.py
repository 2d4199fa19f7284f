"""Share of its roofline that the VIQR sweep reaches in the traced window: its least possible time over the device time of everything launched inside its spans, in percent."""

from benchmark.work import roofline_pct


def read(run):
    return roofline_pct(run, "viqr_acq")
