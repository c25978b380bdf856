"""Everything is found by its name, and a cell, traffic mix, driver kind or
metric added as files is run without editing another file."""

from __future__ import annotations

import json
import os
import time

import torch

from benchmark.harness import files, runner


def test_every_named_file_is_found():
    spec = files.benchmark_json()
    for c in spec["configs"]:
        assert files.config(c["name"])["name"] == c["name"]
        assert os.path.isfile(os.path.join(files.ROOT, c["file"]))
    for w in spec["workloads"]:
        wl = files.workload(w["name"])
        assert (wl["config"], wl["traffic"]) == (w["config"], w["traffic"])
        assert callable(files.driver(files.traffic(w["traffic"])["driver"]))
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(files.metric(m["name"]))


def test_files_added_alone_are_found_and_run(tiny_bench):
    """A new traffic mix, cell, driver kind and metric: four new files and
    new entries in the spec, no other file edited."""
    bench = tiny_bench
    with open(os.path.join(bench, "traffic", "langevin.6.json"), "w") as f:
        json.dump(dict(json.load(open(os.path.join(bench, "traffic", "langevin.1000.json"))),
                       driver="langevin_twice", chains=6), f)
    with open(os.path.join(bench, "workloads", "chignolin.langevin.6.json"), "w") as f:
        json.dump({"config": "chignolin", "traffic": "langevin.6", "limits": {"x_gap_q3": 1e-3}}, f)
    with open(os.path.join(bench, "drivers", "langevin_twice.py"), "w") as f:
        f.write("from benchmark.harness.files import driver\n\n\n"
                "class Driver(driver('langevin', __file__.rsplit('/drivers/', 1)[0])):\n"
                "    def unit(self):\n        super().unit()\n        super().unit()\n")
    with open(os.path.join(bench, "metrics", "calls_per_s.py"), "w") as f:
        f.write("def read(run):\n    return 2 * run.units / run.window_s\n")
    spec = files.benchmark_json()
    spec["workloads"].append({"name": "chignolin.langevin.6", "config": "chignolin",
                              "traffic": "langevin.6", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["chignolin.langevin.6"]})
    for m in spec["end_to_end"]:
        if m["name"] == "chain_steps_per_s":
            m["workloads"].append("chignolin.langevin.6")
    result = runner.run("chignolin.langevin.6", 11, 0.2, False, torch.device("cpu"), time.time(),
                        spec=spec, bench=bench)
    assert result["correct"]
    assert {"calls_per_s", "chain_steps_per_s", "setup_s"} == set(result["metrics"])
