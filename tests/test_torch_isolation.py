"""The port stands alone: no JAX, nothing of photon_tpu, no quiet CPU.

* An AST walk over every module of ``photon_tpu_torch`` and over
  ``chip_smoke.py`` finds no import of ``jax`` or ``photon_tpu``.
* A fresh interpreter imports every port module and ends with no
  ``jax*`` and no ``photon_tpu`` / ``photon_tpu.*`` key in
  ``sys.modules``, and without having built any kernel.
* With no CUDA device, the entry points called without a device raise
  ``RuntimeError`` instead of carrying on on the CPU: the serving engine
  and model, and the training batch, problem and lambda-path trainer.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "photon_tpu_torch")


def _port_files():
    out = []
    for root, _, names in os.walk(PKG):
        out += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return [os.path.join(REPO, "chip_smoke.py")] + sorted(out)


def _modules():
    mods = []
    for path in _port_files()[1:]:
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith(".__init__")
                    else rel)
    return sorted(mods)


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "jaxlib"
            or name.startswith("jaxlib.") or name == "photon_tpu"
            or name.startswith("photon_tpu."))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_photon_tpu_import(path):
    tree = ast.parse(open(path).read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_importing_every_module_pulls_in_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "from photon_tpu_torch.ops import cuda_build\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax') or k == 'photon_tpu' or "
        "k.startswith('photon_tpu.'))\n"
        "print(json.dumps({'n': len(mods), 'bad': bad, "
        "'builds': cuda_build.builds, 'loads': cuda_build.loads}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["n"] >= 20
    assert got["bad"] == []
    assert got["builds"] == 0 and got["loads"] == 0


def test_no_quiet_cpu_fallback(tmp_path, monkeypatch):
    from photon_tpu_torch.device import resolve_device
    from photon_tpu_torch.io.model_io import (load_for_serving,
                                              serving_model_from_arrays)
    from photon_tpu_torch.serving import DeviceResidentModel, ServingEngine

    d = str(tmp_path / "model")
    _write_small_model(d)
    # as on a host without a card, whatever this one has
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ServingEngine.from_model_dir(d)
    with pytest.raises(RuntimeError):
        DeviceResidentModel(load_for_serving(d))
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    sm = serving_model_from_arrays(
        "LINEAR_REGRESSION", [("f", "s", np.ones(2))], [],
        {"s": [("a", ""), ("b", "")]})
    with pytest.raises(RuntimeError):
        DeviceResidentModel(sm)
    # naming the CPU is the one way onto it
    eng = ServingEngine.from_model_dir(d, device="cpu")
    assert eng.model.device == torch.device("cpu")


def test_training_entry_points_raise_without_a_card(monkeypatch):
    from photon_tpu_torch.data.dataset import DataBatch
    from photon_tpu_torch.estimators.model_training import \
        train_generalized_linear_model
    from photon_tpu_torch.optim.problem import GlmOptimizationProblem
    from photon_tpu_torch.types import TaskType

    x = np.ones((4, 2), np.float32)
    y = np.asarray([0.0, 1.0, 0.0, 1.0], np.float32)
    cpu_batch = DataBatch.from_numpy(x, y, device="cpu")
    task = TaskType.LOGISTIC_REGRESSION
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        DataBatch.from_numpy(x, y)
    with pytest.raises(RuntimeError):
        GlmOptimizationProblem(task).run(cpu_batch, dim=2)
    with pytest.raises(RuntimeError):
        train_generalized_linear_model(task, cpu_batch, 2)
    # naming the CPU is the one way onto it
    model, _ = GlmOptimizationProblem(task).run(cpu_batch, dim=2,
                                                device="cpu")
    assert model.coefficients.means.device == torch.device("cpu")


def _write_small_model(d):
    from photon_tpu_torch.game.dataset import EntityVocabulary
    from photon_tpu_torch.game.model import (FixedEffectModel, GameModel,
                                             RandomEffectModel)
    from photon_tpu_torch.io.index_map import IndexMap, feature_key
    from photon_tpu_torch.io.model_io import save_game_model
    from photon_tpu_torch.models.glm import (Coefficients,
                                             GeneralizedLinearModel)
    from photon_tpu_torch.types import TaskType

    task = TaskType.LOGISTIC_REGRESSION
    imap = IndexMap.from_keys(feature_key("f", str(j)) for j in range(4))
    vocab = EntityVocabulary()
    vocab.build("userId", ["a", "b"])
    model = GameModel({
        "fixed": FixedEffectModel(GeneralizedLinearModel(
            Coefficients(torch.arange(1.0, 5.0)), task), "s"),
        "per_user": RandomEffectModel(torch.ones(2, 2), "userId", "s", task),
    })
    save_game_model(d, model, {"s": imap}, vocab,
                    {"per_user": np.asarray([[0, 1], [2, 3]], np.int32)})
