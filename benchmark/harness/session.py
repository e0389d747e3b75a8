"""One run of one cell: build, warm, measure, read the per-layer metrics,
check, and assemble the result line."""

from __future__ import annotations

import dataclasses
import time

import torch

from . import clock, layout
from .drivers import DRIVERS
from .trace import Tracer


@dataclasses.dataclass
class Context:
    """What a per-layer reader sees: the runtime, the driver's records,
    the trace of the window (None untraced), the card's name, and a dict
    each reader may keep its own state in."""

    rt: object
    driver: object
    device_name: str
    trace: object = None
    own: dict = dataclasses.field(default_factory=dict)


def device_block(device: torch.device, count: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": count,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}


def run_cell(spec: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, config: "dict | None" = None,
             mix: "dict | None" = None, faults=()) -> tuple:
    """Run ``cell`` once: ``(result line, info)``, the info being the
    set-up's seconds by part and each iteration's seconds and rounds. ``config``
    and ``mix`` replace the cell's files (the CPU tests run tiny copies);
    ``faults`` are applied to the population before the window (the
    tests and the control break the timed path with them)."""
    config = config if config is not None else layout.config_of(spec, cell)
    mix = mix if mix is not None else layout.traffic_of(cell)
    app = layout.app_module(config)
    reference = layout.reference_module(config)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    t_build = time.perf_counter()
    pop = app.build(config, seed, device)
    pop.parts.seconds = {"imports_and_cuda_init": t_build - t_start,
                         **pop.parts.seconds}
    tracer = Tracer(trace)
    driver = DRIVERS[mix["driver"]](pop, mix, seed, device, reference, tracer,
                                    spans=trace)
    for fault in faults:
        fault(driver)
    driver.warm()
    clock.sync(device)
    name = device_block(device, cell["chips"])["kind"]
    ctx = Context(pop.rt, driver, name)
    readers = []
    if trace:
        for m in layout.per_layer_of(spec, cell):
            mod = layout.metric_module(m["name"])
            readers.append((m, mod))
            if hasattr(mod, "install"):
                mod.install(ctx)
    setup_s = time.perf_counter() - t_start
    with tracer.window():
        out = driver.run(seconds)
    clock.sync(device)
    dev = device_block(device, cell["chips"])
    metrics, breakdown = {}, None
    t_read = time.perf_counter()
    if trace:
        ctx.trace = tracer.read()
        for m, mod in readers:
            value = mod.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if ctx.trace is not None:
            dev["busy_s"] = ctx.trace.busy_s
            dev["window_s"] = ctx.trace.window_s
            breakdown = ctx.trace.breakdown()
    else:
        units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
        for m in layout.end_to_end_of(spec, cell):
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] in out["metrics"]:
                metrics[m["name"]] = {"value": out["metrics"][m["name"]],
                                      "unit": units[m["name"]]}
    checks = driver.check()
    result = {"correct": all(v <= limit for _n, v, limit in checks),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {n: {"value": v, "limit": limit} for n, v, limit in checks}
    info = {"setup_parts": dict(pop.parts.seconds),
            "trace_read_s": time.perf_counter() - t_read if trace else 0.0,
            "iterations": {"seconds": driver.records.seconds,
                           "rounds": driver.records.rounds}}
    return result, info
