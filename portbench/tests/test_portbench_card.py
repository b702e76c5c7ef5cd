"""On a CUDA card only: one short run of each cell through ``main``'s
path, correct, with the device fields the driver reads."""

import pytest

from portbench import run, spec


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in spec.benchmark()["workloads"]])
def test_cell_runs_correct_on_the_card(workload, cuda_device):
    res = run.execute(spec.load(workload), 2**31 + 99, 2.0, True, device=cuda_device,
                      t_start=run.process_start_s())
    assert res["correct"] and res["attempted"] >= 2
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert set(res["metrics"]) == {m["name"] for m in spec.load(workload).per_layer}
