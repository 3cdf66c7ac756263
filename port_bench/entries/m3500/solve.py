"""One graph a request: its optimizer reset to the file's vertices, then
``initialize("chordal")`` and ``solve()``, as a back end that re-solves a
graph it has loaded."""

from __future__ import annotations

import time

import numpy as np


def make(system):
    torch = system.torch
    record = torch.profiler.record_function

    def serve(items):
        answers, counters = [], {"init_s": 0.0, "solve_s": 0.0, "lm_iterations": 0}
        for k in items:
            opt = system.opts[k]
            for vid, xyt in system.files[k].items():
                opt.set_pose(vid, xyt)
            t0 = time.perf_counter()
            with record("pb.init"):
                opt.initialize(method=system.cfg["init"])
                system.sync()
            t1 = time.perf_counter()
            with record("pb.solve"):
                summary, _ = opt.solve(system.options)
                system.sync()
            t2 = time.perf_counter()
            ids = opt.pose_indices()
            answers.append((np.stack([opt.get_pose(v) for v in ids]), summary.final_cost))
            counters["init_s"] += t1 - t0
            counters["solve_s"] += t2 - t1
            counters["lm_iterations"] += int((~torch.isnan(summary.records.cost)).sum())
        return answers, counters

    return serve
