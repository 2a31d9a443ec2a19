"""The port's ``run_bbh`` with ``select_route``, snapshot pooling
(``n_snapshots``) and the ELBO library selection (``select_best``), alone
and in ``chip_smoke.py``'s recipe, as tiny CPU runs checked by
tests/test_torch_workload_routes.py's :func:`run_option_case` (finish, the
reference's jsonl and summary schema, the path taken). A file of its own so
that the test workers share the runs.
"""

import pytest
from test_torch_workload_routes import run_option_case
from torch_threads import two_torch_threads  # noqa: F401 (autouse fixture)

CASES = {
    "select_route": {"select_route": "elbo"},
    "select_best_snapshots": {"select_best": "elbo", "n_snapshots": 2},
    "snapshots": {"n_snapshots": 2},
    "chip_recipe": {"conv_impl": "pallas", "pe_mlrc": 1, "reweight_temper": 1.0,
                    "select_best": "elbo", "n_snapshots": 2},
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_run_bbh_option(tmp_path, monkeypatch, case):
    run_option_case(tmp_path, monkeypatch, CASES[case])
