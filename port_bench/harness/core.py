"""What one run of one cell is made of: the files the cell names, found by
name, the context a generator runs in, and what a generator hands back.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Its files:

* the configuration: the ``file`` of its entry in ``configs``;
* the traffic mix: ``port_bench/traffic/<traffic>.json`` (its
  ``generator`` names the general generator that reads it);
* the limits of its correctness numbers: ``port_bench/limits/<cell>.json``;
* the metrics it reports: ``port_bench/metrics/<metric>.py``, each a
  ``read(run)`` that returns a number or None;
* the plain references: ``port_bench/reference/<name>.py``, as the
  configuration names them.

Adding a configuration of any family the system registers takes new files
alone, and no edit of the harness:

* ``port_bench/configs/<name>.json``: ``port_preset`` (the system's preset
  it starts from), ``reference`` and ``step_reference`` (module names under
  ``port_bench/reference/``), and the sections ``model``, ``train`` and
  ``optim``. ``model`` states ``family`` (the system's model name),
  ``in_channels``, ``num_classes``, ``sensor_dim``, ``uses_sensor``,
  ``seq_len`` and ``num_joints``; ``stages`` for an STGCAN family; and
  ``kwargs``, the family's constructor settings, laid over the preset's
  (:func:`port_config`);
* ``port_bench/reference/<reference>.py``: the plain reference, a
  ``build(model)`` that returns a module under the system's state_dict names
  with ``forward(skeleton, sensor) -> logits``, and, where they apply:
  ``raw_leaves(model, scheme)``, yielding ``(tensor, scale, offset)`` for
  parameters that no module-type rule of ``weights.seed_weights`` draws
  (one of two or more dimensions that nothing yields is refused there); and
  ``forward_flops(model)``, one window's FLOPs through the published
  forward, for a family ``costs.forward_flops`` does not count (the
  ``mfu`` metrics read it);
* ``port_bench/traffic/<traffic>.json``, where no traffic file fits;
* ``port_bench/limits/<cell>.json`` for each new cell;
* ``port_bench/metrics/<metric>.py`` for each new metric;
* the entries in ``BENCHMARK.json``: the configuration, its cells, and the
  cells' names appended to the ``workloads`` of each existing metric they
  report.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

BANNED_MODULES = ("jax", "jaxlib", "flax", "fall_multimodal_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def deep_merge(base: dict, extra: Optional[dict]) -> dict:
    out = copy.deepcopy(base)
    for k, v in (extra or {}).items():
        out[k] = deep_merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) \
            else copy.deepcopy(v)
    return out


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict                  # the configuration file
    traffic: dict                 # the traffic mix file
    limits: dict                  # {number: {"limit": x, ...}}
    metrics: Dict[str, dict]      # the BENCHMARK.json entries this run reports
    readers: Dict[str, Any]       # metric name -> module with read(run)
    references: Dict[str, str]    # "reference", "step_reference" -> the module's file


def applicable(entry: dict, cell: str, reported: List[str]) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") is None or entry["moves"] in reported


def load_cell(root: str, workload: str, trace: bool, overrides: Optional[dict] = None) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json`` with its files.
    ``overrides`` (tests only) merge into the configuration
    (``{"config": {...}}``) and the traffic (``{"traffic": {...}}``)."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {workload!r}")
    return make_cell(root, bench, entry, trace, overrides)


def make_cell(root: str, bench: dict, entry: dict, trace: bool,
              overrides: Optional[dict] = None) -> Cell:
    """A cell from a ``workloads`` entry of ``bench``: its configuration,
    traffic, limits (none if the cell has no file of them) and metric
    readers, and the files of the references it names. The configuration's
    ``model`` section also gets the reference module's file
    (``reference_file``), so that what is handed only that section
    (``costs.forward_flops``) finds the module's hooks."""
    workload = entry["name"]
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    overrides = overrides or {}
    here = os.path.join(root, "port_bench")
    config = deep_merge(_read_json(os.path.join(root, conf["file"])), overrides.get("config"))
    references = {key: os.path.join(here, "reference", f"{config[key]}.py")
                  for key in ("reference", "step_reference")}
    config["model"]["reference_file"] = references["reference"]
    traffic = deep_merge(_read_json(os.path.join(here, "traffic", f"{entry['traffic']}.json")),
                         overrides.get("traffic"))
    limits_file = os.path.join(here, "limits", f"{workload}.json")
    limits = _read_json(limits_file) if os.path.exists(limits_file) else {}
    e2e = [m["name"] for m in bench["end_to_end"] if applicable(m, workload, [])]
    pool = bench["per_layer"] if trace else bench["end_to_end"]
    metrics = {m["name"]: m for m in pool if applicable(m, workload, e2e)}
    readers = {name: load_module(os.path.join(here, "metrics", f"{name}.py"),
                                 f"port_bench_metric_{name.replace('.', '_')}")
               for name in metrics}
    return Cell(workload, int(entry["chips"]), config, traffic, limits, metrics, readers,
                references)


def reference(cell: Cell, key: str = "reference"):
    """The plain reference module that the cell's configuration names under
    ``key``, loaded from the cell's own checkout."""
    path = cell.references[key]
    return load_module(path, f"port_bench_reference_{os.path.splitext(os.path.basename(path))[0]}")


def read_counter(spec: str) -> int:
    """A counter of the system under test, ``"module:attr.attr"``."""
    module, _, path = spec.partition(":")
    obj = importlib.import_module(module)
    for part in path.split("."):
        obj = getattr(obj, part)
    return int(obj)


@contextlib.contextmanager
def float32(tf32: bool = False):
    """cuBLAS's and cuDNN's TF32 switches set to ``tf32`` inside the block."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def card_state() -> str:
    """The card's name, power limit, SM clock, power draw and temperature, as
    ``nvidia-smi`` reads them (one line per card)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi not available ({exc.__class__.__name__})"
    return out.stdout.strip().replace("\n", " | ") or out.stderr.strip()


def host_speed_ms(n: int = 300_000) -> float:
    """Milliseconds of a fixed pure-Python loop: the speed of the host CPU as
    this process gets it. A host-bound cell's rate follows it."""
    t = time.perf_counter()
    s = 0
    for i in range(n):
        s += i * i
    return 1e3 * (time.perf_counter() - t)


def host_counters() -> Dict[str, Any]:
    """The clock, this process's CPU seconds and the host's speed so far."""
    return {"t": time.perf_counter(), "cpu_s": time.process_time(), "speed_ms": host_speed_ms()}


def host_note(before: Dict[str, Any], after: Dict[str, Any]) -> str:
    """The host over a stretch between two ``host_counters``: the CPUs this
    process may run on, its CPU seconds, the host-speed loop at both ends."""
    cpus = sorted(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else []
    parts = [f"{len(cpus)} CPUs allowed"]
    if "t" in before and "t" in after:
        parts.append(f"this process {after['cpu_s'] - before['cpu_s']:.3f} CPU s in "
                     f"{after['t'] - before['t']:.3f} s")
        parts.append(f"host-speed loop {before['speed_ms']:.3f} ms before the window, "
                     f"{after['speed_ms']:.3f} ms after")
    return "; ".join(parts)


def port_config(config: dict):
    """The system's own configuration object for a configuration file: its
    preset, with every size and setting the file states laid over it. The
    model is the file's ``family``; its constructor settings are the
    preset's ``model.kwargs`` with the file's ``model.kwargs`` laid over
    them, and ``model.stages`` where the file states it."""
    from fall_multimodal_tpu_torch.configs import load_config, preset_path

    m, t, o = config["model"], config["train"], config["optim"]
    path = preset_path(config["port_preset"])
    overrides = {"model.name": m["family"]}
    if "kwargs" in m:
        overrides["model.kwargs"] = {**load_config(path).model.kwargs, **m["kwargs"]}
    if "stages" in m:
        overrides["model.kwargs.stages"] = m["stages"]
    overrides.update({
        "data.in_channels": m["in_channels"], "data.num_classes": m["num_classes"],
        "data.sensor_dim": m["sensor_dim"], "data.seq_len": m["seq_len"],
        "data.num_joints": m["num_joints"],
        "model.softmax_output": t["softmax_output"], "train.batch_size": t["batch_size"],
        "train.epochs": t["epochs"], "train.max_norm": t["max_norm"], "train.dtype": t["dtype"],
        "train.drop_last": t["drop_last"], "optim.type": o["type"], "optim.lr": o["lr"],
        "optim.rms_decay": o["rms_decay"], "optim.eps": o["eps"],
        "optim.momentum": o["momentum"], "optim.weight_decay": o["weight_decay"],
    })
    return load_config(path, overrides=overrides)


class Ctx:
    """What a generator runs with: the cell, the seed, the window's length, the
    device, the tracer, and the clock of the process's start."""

    def __init__(self, cell: Cell, seed: int, seconds: float, device, tracer, t_process: float):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.device, self.tracer, self.t_process = device, tracer, t_process
        self.config, self.traffic = cell.config, cell.traffic
        self.model = cell.config["model"]
        self.setup_s: Optional[float] = None
        self.card_before = self.card_after = ""
        self.counters: Dict[str, str] = {}
        for reader in cell.readers.values():
            self.counters.update(getattr(reader, "COUNTERS", {}))
        self._at_trace_start: Dict[str, int] = {}
        self.counter_deltas: Dict[str, int] = {}
        self.trace_t0 = 0.0
        self._host_before: Dict[str, Any] = {}
        self._host_after: Dict[str, Any] = {}
        self.stages: List[tuple] = []

    def mark(self, stage: str) -> None:
        """Set-up reached the end of ``stage``: its time from the process's start."""
        self.stages.append((stage, time.perf_counter() - self.t_process))

    def stages_note(self) -> str:
        return "set-up stages, seconds from the process's start: " + ", ".join(
            f"{name} {at:.3f}" for name, at in self.stages)

    def open_window(self) -> float:
        """Set-up ends here: the card is sampled and the window's clock starts."""
        self.tracer.prime()
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)
            self.card_before = card_state()
        self._host_before = host_counters()
        self.mark("window opens")
        t0 = time.perf_counter()
        self.setup_s = t0 - self.t_process
        return t0

    def close_window(self) -> None:
        self._host_after = host_counters()
        if self.device.type == "cuda":
            self.card_after = card_state()

    def host_note(self) -> str:
        return host_note(self._host_before, self._host_after)

    def start_trace(self) -> None:
        if self.tracer.enabled and self.tracer.prof is None:
            self._at_trace_start = {k: read_counter(v) for k, v in self.counters.items()}
            self.tracer.start()
            self.trace_t0 = time.perf_counter()

    def stop_trace(self) -> None:
        if self.tracer.active:
            self.tracer.stop()
            self.counter_deltas = {k: read_counter(v) - self._at_trace_start[k]
                                   for k, v in self.counters.items()}


@dataclasses.dataclass
class Outcome:
    """What a generator measured and compared."""

    attempted: int
    failed: int
    host: Dict[str, Any]                 # host-clock measurements for the readers
    checks: Dict[str, float]             # the numbers compared with the limits
    memory_peak_bytes: int
    notes: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cell: Cell
    device_name: str
    setup_s: float
    host: Dict[str, Any]
    trace: Any                           # trace.Trace, or None
    counters: Dict[str, int]
    peaks: Optional[Dict[str, float]]
