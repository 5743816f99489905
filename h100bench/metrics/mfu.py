"""The whole call's or step's share of the card's peak in the traced
window, in %: the model's operations a call or step (``flops.UNIT_OPS`` of
the traffic's ``kind``) times the calls or steps, over the window's seconds
and the peak of the traffic's ``precision`` (``peaks.PEAK_OPS_S``; 67
TFLOP/s for float32 with TF32 off). Read for every ``mfu.<cell>``."""

from h100bench import flops
from h100bench.peaks import PEAK_OPS_S


def read(run):
    t = run.traced
    if t is None or not t.units:
        return None
    tr = run.cell.traffic
    ops = flops.UNIT_OPS[tr["kind"]](run.cell.config, tr)
    return 100.0 * ops * t.units / t.window_s / PEAK_OPS_S[tr["precision"]]
