"""The measurement tools of the s2t_tpu_torch port, on the CPU with stand-in checkouts."""

import json

import pytest

from s2t_tpu_torch.tools import train_step_ab
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

STAND_IN = """
class _build:
    @staticmethod
    def build():
        return {{}}


def phase_train_speed():
    res = {{k: 1.0 for k in {keys!r}}}
    res.update(step_ms={step_ms}, kernel_device_ms={{"k": 0.5}})
    return res, {{}}
"""


def _tree(root, name, step_ms):
    tree = root / name
    tree.mkdir()
    (tree / "chip_smoke.py").write_text(STAND_IN.format(keys=train_step_ab.KEYS, step_ms=step_ms))
    return tree


def test_train_step_ab_runs_each_tree_from_its_own_root(tmp_path):
    a, b = _tree(tmp_path, "a", 100.0), _tree(tmp_path, "b", 150.0)
    assert train_step_ab.run_tree(a)["step_ms"] == 100.0
    res = train_step_ab.run_tree(b)
    assert res["step_ms"] == 150.0 and res["kernel_device_ms"] == {"k": 0.5}
    assert set(res) == set(train_step_ab.KEYS)


def test_train_step_ab_reports_a_failed_tree(tmp_path):
    tree = tmp_path / "broken"
    tree.mkdir()
    (tree / "chip_smoke.py").write_text("raise SystemExit(3)\n")
    with pytest.raises(RuntimeError, match="exit 3"):
        train_step_ab.run_tree(tree)


def test_train_step_ab_medians_per_tree(tmp_path, monkeypatch, capsys):
    a, b = _tree(tmp_path, "a", 100.0), _tree(tmp_path, "b", 150.0)
    monkeypatch.setattr(train_step_ab.subprocess, "run", _fake_smi(train_step_ab.subprocess.run))
    out = tmp_path / "ab.json"
    assert train_step_ab.main([str(a), str(b), str(b), str(a), "--out", str(out)]) == 0
    median = json.loads(capsys.readouterr().out.splitlines()[-1])["median"]
    assert median[str(a)]["step_ms"] == 100.0 and median[str(b)]["step_ms"] == 150.0
    assert [r["tree"] for r in json.loads(out.read_text())["runs"]] == [str(a), str(b), str(b), str(a)]


def _fake_smi(run):
    class Done:
        stdout = "NVIDIA H100 80GB HBM3, 700.00 W\n"

    def fake(cmd, **kw):
        return Done() if cmd[0] == "nvidia-smi" else run(cmd, **kw)

    return fake
