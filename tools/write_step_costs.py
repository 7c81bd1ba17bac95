"""Write ``src/repro_torch/serve/step_costs.json``: the per-token step costs
that the JAX package's machine-model simulator gives for each operating point
the port's policy table can resolve without a calibration artifact (the
default point, and its geometry under each pinned policy).

  PYTHONPATH=src python tools/write_step_costs.py

The port reads the file in ``StepCostModel.from_operating_point``;
``tests/test_torch_serve.py`` recomputes every entry with the simulator and
requires equality, so the file cannot drift from the reference.
"""
import dataclasses
import json
import os

from repro.core.policy import ExecutionPolicy, OperatingPoint
from repro.serve.scheduler import StepCostModel

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                   "src", "repro_torch", "serve", "step_costs.json")


def points():
    """The default point, then its geometry pinned to each policy (what
    ``PolicyTable.resolve("serve", policy=p)`` returns)."""
    yield OperatingPoint()
    for p in ExecutionPolicy:
        yield dataclasses.replace(OperatingPoint(), policy=p,
                                  source="override")


def entry(op: OperatingPoint, workload: str = "serve",
          n_samples: int = 32) -> dict:
    point = dataclasses.asdict(op)
    point["policy"] = op.policy.value
    cost = StepCostModel.from_operating_point(op, workload=workload,
                                              n_samples=n_samples)
    return {"point": point, "workload": workload, "n_samples": n_samples,
            "cost": dataclasses.asdict(cost)}


def main() -> None:
    doc = {"about": "per-token step costs from repro.core.sweep.run_point; "
                    "regenerate with tools/write_step_costs.py",
           "entries": [entry(op) for op in points()]}
    with open(OUT, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(f"wrote {len(doc['entries'])} entries to {os.path.normpath(OUT)}")


if __name__ == "__main__":
    main()
