"""The port's dialog ILQL and Twenty-Questions gates against the JAX gates
on the JAX gates' own draws: `test_torch_dialog_gate_parity.py`'s check
(the budgets, cuts and tolerances stated there), in a file of its own so
the test runner spreads the gate runs over two workers."""
import pytest
import torch

from test_torch_dialog_gate_parity import check_port_gate


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as in `test_torch_dialog_gate_parity.py`."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_dialog_ilql_gate_matches_jax_gate(monkeypatch):
    out, calls = check_port_gate("dialog_ilql", monkeypatch)
    assert out["gate_env"] == "lm_oracle" and out["oracle_fidelity"] is not None
    assert any(len(c["prompts"]) == 100 for c in calls)  # the batched oracle-fidelity probe


def test_port_twenty_questions_gate_matches_jax_gate(monkeypatch):
    check_port_gate("twenty_questions", monkeypatch)
