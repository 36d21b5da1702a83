"""The port's hyperparameter searches (``integrations/``) and the CLI's
``--hyperparameter-tuning`` dispatch, on the CPU, against the JAX
package's.

- ``suggest_args`` under ``tests/test_integrations.py``'s ``FakeTrial``
  gives the same flags in both packages, value for value;
- ``native_asha_pipeline`` draws the same five values a trial as JAX's,
  bit for bit, for two seeds;
- ``asha_search`` over a scripted stand-in runner, patched into both
  packages (5 trials, ``max_t`` 5, reduction 2): the same steps in the
  same order, the same pruned trials, histories and winner;
- a ``TrialRunner`` of a small medmamba (depths (1, 1), dims (8, 16),
  d_state 4, DropPath off, image 32, a deterministic crop: the train-step
  tests' set-up) carried over from JAX's runner by
  ``convert.train_state_from_jax``: after one ``step()`` the validation
  loss within 1e-5 (fp32; GEMM, convolution and reduction order differ);
  its save and restore bit for bit;
- the objective's NaN guard, its report each epoch and its mid-trial
  prune; the optuna and ray gates' messages equal JAX's where the packages
  are missing; both searches' control flow over stand-in modules;
- the CLI's three strategies and an unknown one.
"""

import math
import sys
import types

import jax
import numpy as np
import pytest
import torch
from test_integrations import FakeTrial

from mamba_clip_tpu import config as jcfg
from mamba_clip_tpu.integrations import optuna as jopt
from mamba_clip_tpu.integrations import ray as jray
from mamba_clip_tpu.integrations import runner as jrunner
from mamba_clip_tpu_torch import config as tcfg
from mamba_clip_tpu_torch import models as tmodels
from mamba_clip_tpu_torch.cli.main import main
from mamba_clip_tpu_torch.convert import train_state_from_jax
from mamba_clip_tpu_torch.integrations import optuna as topt
from mamba_clip_tpu_torch.integrations import ray as tray
from mamba_clip_tpu_torch.integrations import runner as trunner
from mamba_clip_tpu_torch.optim import build_optimizer

# The plain paths are Python loops of small tensor ops: one intra-op thread
# runs them as fast as eight alone, and keeps them from stalling (up to ten
# times slower) when the test workers share the machine's cores.
torch.set_num_threads(1)

TINY = dict(depths=(1, 1), dims=(8, 16), d_state=4, num_classes=2, drop_path_rate=0.0)
AUG = ["scale=1.0,1.0", "ratio=1.0,1.0", "hflip=0.0", "re_prob=0.0"]


def _flags(**kw):
    base = dict(synthetic_data=True, batch_size=8, epochs=2, train_num_samples=16,
                val_num_samples=8, lr=1e-3, warmup=0, precision="fp32", workers=1,
                force_image_size=[32], num_classes=2, log_every_n_steps=100, seed=0,
                aug_cfg=AUG, device="cpu")
    return {**base, **kw}


def _tiny_port(args):
    from mamba_clip_tpu_torch.models.vssm import VSSM

    return VSSM(**TINY, generator=torch.Generator().manual_seed(args.seed))


@pytest.mark.parametrize("seed", range(4))
def test_suggest_args_equal_jax(seed):
    base = dict(undersample=50_000, epochs=3, name="study")
    want = jopt.suggest_args(FakeTrial(seed=seed), jcfg.Args(**base)).to_dict()
    got = topt.suggest_args(FakeTrial(seed=seed), tcfg.Args(**base)).to_dict()
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("seed", [0, 7])
def test_native_asha_draws_equal_jax_bit_for_bit(monkeypatch, seed):
    seen = {}

    def recorder(which):
        def asha_search(make_args, n_trials, **kw):
            seen[which] = ([make_args(t).to_dict() for t in range(n_trials)], kw)
            return {"best_trial": 0, "best_metrics": {}, "pruned": [], "history": [[]]}
        return asha_search

    monkeypatch.setattr(jrunner, "asha_search", recorder("jax"))
    monkeypatch.setattr(trunner, "asha_search", recorder("port"))
    flags = dict(seed=seed, training_iterations=4, epochs=3, hopt_direction="maximize",
                 eval_loss="partial_auc")
    jray.native_asha_pipeline(jcfg.Args(**flags))
    tray.native_asha_pipeline(tcfg.Args(**flags))
    (want, want_kw), (got, got_kw) = seen["jax"], seen["port"]
    assert got_kw == want_kw == dict(metric="partial_auc", mode="max", max_t=3)
    keys = ("lr", "beta1", "beta2", "wd", "grad_clip_norm")
    assert [[g[k] for k in keys] for g in got] == [[w[k] for k in keys] for w in want]
    assert len({g["lr"] for g in got}) == 4


def _scripted(log):
    """A stand-in TrialRunner whose metric is a fixed function of (trial,
    epoch); every step is logged."""

    class Scripted:
        def __init__(self, args, trial_id=0, model_factory=None):
            self.args, self.t, self.epoch = args, trial_id, 0

        def step(self):
            self.epoch += 1
            log.append((self.t, self.epoch))
            v = ((self.t * 37 + self.epoch * 11) % 17) / 17.0 + 0.01 * self.t
            return {"val_loss": v, "training_iteration": self.epoch}

    return Scripted


@pytest.mark.parametrize("mode", ["min", "max"])
def test_asha_search_decides_as_jax(monkeypatch, mode):
    logs = {"jax": [], "port": []}
    monkeypatch.setattr(jrunner, "TrialRunner", _scripted(logs["jax"]))
    monkeypatch.setattr(trunner, "TrialRunner", _scripted(logs["port"]))
    kw = dict(n_trials=5, metric="val_loss", mode=mode, max_t=5, grace_period=1,
              reduction_factor=2)
    want = jrunner.asha_search(lambda t: jcfg.Args(epochs=5), **kw)
    got = trunner.asha_search(lambda t: tcfg.Args(epochs=5), **kw)
    assert got == want
    assert logs["port"] == logs["jax"]
    assert len(want["pruned"]) == 4 and len(want["history"][want["best_trial"]]) == 5


@pytest.fixture(scope="module")
def runners():
    """JAX's TrialRunner on the small medmamba and the port's carried over
    from it, each after one ``step()``."""
    from mamba_clip_tpu.models.vssm import VSSM as JVSSM

    jr = jrunner.TrialRunner(jcfg.Args(**_flags()),
                             model_factory=lambda a: JVSSM(scan_impl="xla", **TINY))
    tr = trunner.TrialRunner(tcfg.Args(**_flags()), model_factory=_tiny_port)
    js = jr.params["state"]
    adam = [s for s in jax.tree_util.tree_leaves(
        js.opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")][0]
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tx = build_optimizer(tr.args, tr.params["schedule"])
    tr.params["state"] = train_state_from_jax(
        tr.model, tx, params=to_np(js.params), mu=to_np(adam.mu), nu=to_np(adam.nu),
        count=int(adam.count), step=int(js.step), batch_stats=to_np(js.batch_stats))
    return jr, jr.step(), tr, tr.step()


def test_trial_runner_step_matches_jax(runners):
    _, want, tr, got = runners
    assert got["training_iteration"] == want["training_iteration"] == tr.epoch == 1
    assert set(got) == set(want)
    assert abs(got["val_loss"] - float(want["val_loss"])) <= 1e-5
    assert got["num_samples"] == want["num_samples"] == 8


def test_trial_runner_save_restore_bit_for_bit(runners, tmp_path):
    _, _, tr, _ = runners
    path = tr.save(str(tmp_path))
    assert path.endswith("trial_0_epoch_1")
    fresh = trunner.TrialRunner(tr.args, model_factory=_tiny_port)
    fresh.restore(path)
    assert fresh.epoch == 1 and fresh.params["state"].step == tr.params["state"].step
    a, b = tr.model.state_dict(), fresh.model.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    for k, v in tr.params["state"].opt_state.mu.items():
        assert torch.equal(v, fresh.params["state"].opt_state.mu[k])


class FakeRunner:
    vals = [0.5, 0.42]

    def __init__(self, args, trial_id=0, model_factory=None):
        self.i = 0

    def step(self):
        v = self.vals[self.i]
        self.i += 1
        return {"val_loss": v}


def test_objective_nan_guard_reports_and_prunes(monkeypatch):
    base = tcfg.Args(hopt_direction="minimize", eval_loss="val_loss", epochs=2)

    class Boom:
        def __init__(self, *a, **k):
            raise ValueError("loss is NaN")

    monkeypatch.setattr(trunner, "TrialRunner", Boom)
    assert topt.make_objective(base)(FakeTrial()) == math.inf

    class NaNRunner(FakeRunner):
        vals = [float("nan")]

    monkeypatch.setattr(trunner, "TrialRunner", NaNRunner)
    assert topt.make_objective(base)(FakeTrial()) == math.inf
    assert topt.make_objective(base.replace(hopt_direction="maximize"))(FakeTrial()) == 0.0

    monkeypatch.setattr(trunner, "TrialRunner", FakeRunner)
    trial = FakeTrial()
    assert topt.make_objective(base)(trial) == pytest.approx(0.42)
    assert trial.reported == [(0.5, 0), (0.42, 1)]

    fake_optuna = types.ModuleType("optuna")

    class TrialPruned(Exception):
        pass

    fake_optuna.TrialPruned = TrialPruned
    monkeypatch.setitem(sys.modules, "optuna", fake_optuna)
    with pytest.raises(TrialPruned):
        topt.make_objective(base)(FakeTrial(prune_after=0))


def test_gates_name_their_package_as_jax_does(monkeypatch):
    for name in ("optuna", "ray", "ray.tune"):
        monkeypatch.setitem(sys.modules, name, None)  # an import of it raises ImportError
    for j, t in ((jopt._require_optuna, topt._require_optuna),
                 (jray._require_ray, tray._require_ray)):
        with pytest.raises(ImportError) as want:
            j()
        with pytest.raises(ImportError) as got:
            t()
        assert str(got.value) == str(want.value)
    assert "optuna is not installed" in str(got.value) or "ray[tune]" in str(got.value)
    with pytest.raises(ImportError, match="ray"):
        main(["--hyperparameter-tuning", "--hyperparameter-strategy", "ray", "--device", "cpu"])
    with pytest.raises(ImportError, match="optuna"):
        main(["--hyperparameter-tuning", "--device", "cpu"])  # optuna is the default


def _stand_in_optuna(log):
    optuna = types.ModuleType("optuna")
    optuna.TrialPruned = type("TrialPruned", (Exception,), {})

    class Study:
        study_name = "s"

        def optimize(self, objective, n_trials):
            self.values = [objective(FakeTrial(number=i, seed=i)) for i in range(n_trials)]
            self.best_value = min(self.values)
            self.best_trial = types.SimpleNamespace(number=self.values.index(self.best_value))
            self.best_params = {"n": n_trials}

    def create_study(**kw):
        log.append(kw)
        return Study()

    optuna.create_study = create_study
    optuna.samplers = types.SimpleNamespace(
        TPESampler=lambda **kw: log.append(("sampler", kw)) or "sampler")
    return optuna


def test_optuna_pipeline_over_a_stand_in_module(monkeypatch, tmp_path):
    log = []
    monkeypatch.setitem(sys.modules, "optuna", _stand_in_optuna(log))
    monkeypatch.setitem(sys.modules, "joblib", None)
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setattr(trunner, "TrialRunner", FakeRunner)
    args = tcfg.Args(training_iterations=3, epochs=2, seed=5, logs=str(tmp_path),
                     eval_loss="val_loss", optuna_study_name="study-x")
    assert topt.optuna_pipeline(args) == {"n": 3}
    assert log[0] == ("sampler", {"multivariate": True, "seed": 8})
    assert log[1] == dict(study_name="study-x", storage=None, sampler="sampler",
                          direction="minimize", load_if_exists=True)


def test_ray_tune_pipeline_over_stand_in_modules(monkeypatch):
    log = {}
    ray = types.ModuleType("ray")
    tune = types.ModuleType("ray.tune")
    schedulers = types.ModuleType("ray.tune.schedulers")
    ray.init = lambda **kw: log.setdefault("init", kw)
    ray.tune = tune

    class Trainable:
        trial_id = "trial-a"

    class Tuner:
        def __init__(self, trainable, param_space, tune_config):
            log.update(trainable=trainable, space=param_space, config=tune_config)

        def fit(self):
            cls, _ = log["trainable"]
            t = cls()
            t.setup({"lr": 3e-4, "not_a_flag": 1})
            log["step"] = t.step()
            return types.SimpleNamespace(
                get_best_result=lambda: types.SimpleNamespace(config={"lr": 3e-4}))

    tune.Trainable = Trainable
    tune.Tuner = Tuner
    tune.TuneConfig = lambda **kw: kw
    tune.with_resources = lambda cls, res: (cls, res)
    for prim in ("loguniform", "uniform", "randint", "choice"):
        setattr(tune, prim, lambda *a, _p=prim: (_p, a))
    schedulers.ASHAScheduler = lambda **kw: ("asha", kw)
    monkeypatch.setitem(sys.modules, "ray", ray)
    monkeypatch.setitem(sys.modules, "ray.tune", tune)
    monkeypatch.setitem(sys.modules, "ray.tune.schedulers", schedulers)
    monkeypatch.delenv("ip_head", raising=False)
    made = []

    class Recording(FakeRunner):
        def __init__(self, args, trial_id=0, model_factory=None):
            made.append(args)
            super().__init__(args, trial_id)

    monkeypatch.setattr(trunner, "TrialRunner", Recording)
    args = tcfg.Args(training_iterations=6, epochs=4, device="cpu")
    assert tray.ray_tune_pipeline(args) == {"lr": 3e-4}
    assert log["init"] == {"ignore_reinit_error": True}
    assert log["trainable"][1] == {"cpu": 1}
    assert log["space"] == jray.suggest_config(tune)
    assert log["config"]["num_samples"] == 6
    assert log["config"]["scheduler"] == ("asha", dict(
        time_attr="training_iteration", metric="val_loss", mode="min", max_t=4,
        grace_period=1, reduction_factor=2))
    assert made[0].lr == 3e-4 and log["step"] == {"val_loss": 0.5}


def test_cli_dispatches_each_strategy(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(topt, "optuna_pipeline", lambda a: calls.append("optuna") or 1)
    monkeypatch.setattr(tray, "ray_tune_pipeline", lambda a: calls.append("ray") or 2)
    base = ["--hyperparameter-tuning", "--device", "cpu", "--logs", str(tmp_path)]
    assert main(base) == 1
    assert main(base + ["--hyperparameter-strategy", "ray"]) == 2
    assert calls == ["optuna", "ray"]
    with pytest.raises(ValueError, match="unknown hyperparameter strategy: grid"):
        main(base + ["--hyperparameter-strategy", "grid"])
    with pytest.raises(ValueError) as want:
        from mamba_clip_tpu.cli.main import main as jmain

        jmain(["--hyperparameter-tuning", "--hyperparameter-strategy", "grid"])
    assert str(want.value) == "unknown hyperparameter strategy: grid"


def test_cli_asha_runs_two_trials_and_prunes_one(monkeypatch, tmp_path):
    """The asha strategy end to end on the CPU through the CLI: two trials,
    one stopped at the first rung, the winner trained to ``--epochs``."""
    monkeypatch.setattr(tmodels, "build_classifier",
                        lambda name, generator=None, **kw: tmodels.VSSM(**TINY,
                                                                        generator=generator))
    argv = ["--hyperparameter-tuning", "--hyperparameter-strategy", "asha", "--device", "cpu",
            "--synthetic-data", "--model", "medmamba", "--precision", "fp32",
            "--training-iterations", "2", "--epochs", "2", "--batch-size", "8",
            "--train-num-samples", "16", "--val-num-samples", "8", "--force-image-size", "32",
            "--logs", str(tmp_path)]
    result = main(argv)
    assert len(result["pruned"]) == 1 and result["best_trial"] != result["pruned"][0]
    assert len(result["history"][result["best_trial"]]) == 2
    assert len(result["history"][result["pruned"][0]]) == 1
    assert np.isfinite(result["best_metrics"]["val_loss"])
