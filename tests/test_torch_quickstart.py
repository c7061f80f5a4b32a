"""The port's quickstart (``python -m repro_torch.quickstart``) on the
CPU at a few steps: llama-tiny under ``lowrank_adam`` with the Stiefel
sampler, as the JAX package's ``examples/quickstart.py``; the loss falls
and no step is skipped."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch import quickstart  # noqa: E402


def test_quickstart_loss_falls_on_the_cpu():
    lines = []
    report = quickstart.train("cpu", steps=12, log_every=4,
                              out=lines.append)
    losses = report.losses
    assert report.steps_run == 12 and len(losses) == 12
    assert all(l == l and l < 20 for l in losses)         # finite
    assert sum(losses[-3:]) / 3 < losses[0]
    assert report.skipped_steps == 0 and report.rollbacks == 0
    assert lines[0].startswith("registered methods:")
    assert any(line.startswith("step   12") for line in lines)
    assert lines[-1].startswith(f"loss {losses[0]:.3f} -> ")


def test_quickstart_main_reports_ok(capsys):
    assert quickstart.main(["--device", "cpu", "--steps", "12"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("quickstart OK")
