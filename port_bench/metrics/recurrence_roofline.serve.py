"""The TARGCN recurrence's share of its roofline, in percent: the least time
of the traced window's recurrences (one forward's, from the reference's
``recurrence_cost`` at the cell's batch: its FLOPs at the peak rate or its
bytes at the peak bandwidth, whichever is longer, times the forwards) over
the device time launched from inside the system's ``targcn.recurrence``
spans there. The forwards are the frames the system's counter
``GraphGRUCell.steps`` counted over (frames x layers) a forward."""

from port_bench.harness import core, costs, nested, spans

STEPS = "fall_multimodal_tpu_torch.models.targcn:GraphGRUCell.steps"
COUNTERS = spans.present({"targcn_steps": STEPS})


def read(run):
    steps = run.counters.get("targcn_steps", 0)
    if run.trace is None or run.peaks is None or steps <= 0:
        return None
    ref = core.reference(run.cell)
    m = run.cell.config["model"]
    s = ref.sizes(m)
    busy_ms = nested.device_ms_within(run, "targcn.recurrence", 1)
    if busy_ms is None:
        return None
    forwards = steps / (s["T"] * s["num_layers"])
    least = costs.roofline_ms(*ref.recurrence_cost(m, run.cell.traffic["batch"]), run.peaks)
    return 100.0 * least * forwards / busy_ms
