"""The port's HTTP server on the CPU: routes that are ported answer with the
engine's own values (/gradient with ``engine.gradient``, /fit with the fit's
re-evaluated logL); routes that are not return a clean 501; and the port
imports no JAX."""
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from phylo_utils_tpu_torch import models
from phylo_utils_tpu_torch.likelihood import LikelihoodEngine
from phylo_utils_tpu_torch.server import EngineServer
from phylo_utils_tpu_torch.trees import random_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = {"model": {"rates": [1.2, 3.1, 0.7, 0.9, 4.2, 1.0],
                    "freqs": [0.3, 0.2, 0.22, 0.28]},
          "alpha": 0.7, "pinv": 0.15}


@pytest.fixture(scope="module")
def server():
    tree = random_tree(8, seed=0)
    rng = np.random.default_rng(1)
    aln = {n: "".join(rng.choice(list("ACGT"), size=60))
           for n in tree.leaf_names}
    engine = LikelihoodEngine(tree, aln, models.GTR, ncat=4,
                              invariant_sites=True, dtype=torch.float32,
                              pruner="cuda", device="cpu")
    srv = EngineServer(engine, port=0)  # ephemeral port
    srv.start()
    yield srv, engine
    srv.stop()


def _url(srv, route):
    return f"http://127.0.0.1:{srv.port}{route}"


def _post(srv, route, body=None):
    req = urllib.request.Request(
        _url(srv, route), data=json.dumps(body or {}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _post_status(srv, route, body=None):
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(srv, route, body)
    return exc.value.code, json.loads(exc.value.read())


def test_health(server):
    srv, engine = server
    with urllib.request.urlopen(_url(srv, "/health"), timeout=30) as r:
        h = json.loads(r.read())
    assert h["status"] == "ok" and h["model"] == "GTR"
    assert h["device"] == "cpu" and h["device_name"] == "cpu"
    assert h["pruner"] == "cuda"
    assert h["n_patterns"] == engine._compressed.n_patterns


def test_loglik_and_sitewise(server):
    srv, engine = server
    out = _post(srv, "/loglik", {"params": PARAMS})
    assert out["loglik"] == engine.loglikelihood(PARAMS)
    assert _post(srv, "/loglik")["loglik"] == engine.loglikelihood()
    sw = _post(srv, "/sitewise", {"params": PARAMS})["sitewise"]
    np.testing.assert_array_equal(sw, engine.sitewise_loglikelihoods(PARAMS))
    assert len(sw) == 60
    assert float(np.sum(sw)) == pytest.approx(out["loglik"], abs=1e-9)


def test_bootstrap(server):
    srv, engine = server
    boots = _post(srv, "/bootstrap", {"n": 16, "seed": 3,
                                      "params": PARAMS})["logliks"]
    np.testing.assert_array_equal(
        boots, engine.bootstrap_loglikelihoods(16, PARAMS, seed=3))


def test_gradient_route_matches_engine(server):
    srv, engine = server
    got = _post(srv, "/gradient", {"params": PARAMS})["gradient"]
    want = engine.gradient(PARAMS)
    assert set(got) == set(want) and set(got["model"]) == {"rates", "freqs"}
    np.testing.assert_array_equal(got["branch_lengths"],
                                  want["branch_lengths"].numpy())
    np.testing.assert_array_equal(got["model"]["freqs"],
                                  want["model"]["freqs"].numpy())
    assert got["alpha"] == float(want["alpha"])
    assert np.all(np.isfinite(got["branch_lengths"]))


def test_fit_route_returns_fit_loglik(server):
    srv, engine = server
    start = engine.loglikelihood(PARAMS)
    out = _post(srv, "/fit", {"params": PARAMS, "max_steps": 5,
                              "free": ["branch_lengths", "alpha"]})
    assert out["n_steps"] == 5 and isinstance(out["converged"], bool)
    assert out["loglik"] >= start
    # the reported logL is the engine's at the returned params, and the
    # frozen model parameters came back unchanged
    assert out["loglik"] == pytest.approx(engine.loglikelihood(out["params"]),
                                          abs=1e-9)
    np.testing.assert_allclose(out["params"]["model"]["rates"],
                               PARAMS["model"]["rates"], rtol=1e-6)
    code, body = _post_status(srv, "/fit", {"free": ["kapa"]})
    assert code == 400 and "kapa" in body["error"]


@pytest.mark.parametrize("route", ["/ancestral", "/site_rates", "/partitions"])
def test_unported_routes_return_501(server, route):
    srv, _ = server
    code, body = _post_status(srv, route, {"params": PARAMS})
    assert code == 501
    assert "not ported" in body["error"] or "requires" in body["error"]


def test_errors_are_clean(server):
    srv, _ = server
    assert _post_status(srv, "/nope")[0] == 404
    code, body = _post_status(srv, "/loglik", {"params": {"aplha": 1.0}})
    assert code == 400 and "aplha" in body["error"]


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import phylo_utils_tpu_torch.likelihood\n"
        "import phylo_utils_tpu_torch.server\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'phylo_utils_tpu',"
        " 'oracle'))\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
