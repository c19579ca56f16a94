"""The comparison that decides ``correct`` fails what it must: the
control (the plain reference in bfloat16, below the configurations'
float32, put in the program's place) on every cell, and a run with the
timed path broken underneath, once for each fault the cell can have (a
step that returns its state unchanged, half of a batch left out with the
mean taken over the rest, an answer altered where it is produced).  One
chip: no exchange between chips to leave out.  Small sizes, on the CPU."""
import numpy as np
import pytest
import torch

from portbench_small import CPU, SEED, harness, run_cell, small

BENCH = harness.benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    from portbench.tools import controls
    cfg, tr = small(BENCH, cell, side=6)
    checks = controls.readings(BENCH, cell, SEED, torch.bfloat16, CPU,
                               config=cfg, traffic=tr, seconds=3.0)
    assert checks and not all(c.ok for c in checks)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    _, line = run_cell(cell, seconds=1.0)
    assert line["correct"] is True and line["failed"] == 0


def _fails(cell, **traffic):
    _, line = run_cell(cell, seconds=1.0, **traffic)
    assert line["correct"] is False
    return line


# -- a step that returns its state unchanged --------------------------------

def test_factor_engine_round_unchanged_stops_the_run(monkeypatch):
    """An engine round that eliminates nothing never finishes the factor:
    the program raises (the run fails; it prints no result)."""
    from repro_torch.kernels import sample_clique as sc
    real = sc.eliminate_round

    def stuck(s, st, cand, cand_ok):
        return real(s, st, cand, torch.zeros_like(cand_ok))
    monkeypatch.setattr(sc, "eliminate_round", stuck)
    with pytest.raises(RuntimeError, match="stalled"):
        run_cell("uniform64.factor", seconds=0.5)


@pytest.mark.parametrize("cell", ["uniform64.factor",
                                  "contrast64.factor_fleet4"])
def test_factor_sweep_unchanged(monkeypatch, cell):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "trisolve_fleet_", lambda *a, **kw: a[6])
    line = _fails(cell)
    assert line["checks"]["apply_err"]["value"] > \
        line["checks"]["apply_err"]["limit"]


def test_solve_step_unchanged(monkeypatch):
    from repro_torch.core import pcg
    real = pcg.pcg_fleet_body

    def stuck(fa, s, **kw):
        # the iterate, residual and direction stay; only the count moves
        # (else the solve would never return)
        it = s.it + s.active.to(torch.int32)
        return s._replace(it=it, active=s.active & (it < s.maxiter))
    monkeypatch.setattr(pcg, "pcg_fleet_body", stuck)
    line = _fails("contrast64.solve8")
    assert line["checks"]["resid_ratio"]["value"] > 1e5
    del real


def test_serve_step_unchanged(monkeypatch):
    from repro_torch.serve import engine
    monkeypatch.setattr(engine, "_step_program", lambda fa, s, **kw: s)
    drv = harness.driver("serve_open")
    monkeypatch.setattr(drv, "WARMUP_REQUESTS", 0)
    monkeypatch.setattr(drv, "DRAIN_S", 1.0)
    line = _fails("uniform64.serve")
    assert line["checks"]["unserved"]["value"] == line["attempted"]


# -- half of a batch left out, the mean taken over the rest -----------------

def test_factor_fleet_half_batch(monkeypatch):
    from repro_torch.core.solver import FactorCache
    real = FactorCache.factor_batched

    def half(self, gs, keys, **kw):
        k = len(gs) // 2
        hs = real(self, gs[:k], keys[:k], **kw)
        return hs + hs
    monkeypatch.setattr(FactorCache, "factor_batched", half)
    line = _fails("contrast64.factor_fleet4")
    assert line["checks"]["factor_mismatch"]["value"] > 0


def test_solve_half_batch(monkeypatch):
    from repro_torch.core.solver import PreconditionerHandle
    real = PreconditionerHandle.solve

    def half(self, B, **kw):
        k = B.shape[0] // 2
        res = real(self, B[:k], **kw)
        x = torch.cat([res.x, res.x.mean(dim=0, keepdim=True)
                       .expand(B.shape[0] - k, -1)])
        it = torch.cat([res.iters, res.iters[:1].expand(B.shape[0] - k)])
        return res._replace(x=x, iters=it,
                            converged=torch.ones(B.shape[0], dtype=bool))
    monkeypatch.setattr(PreconditionerHandle, "solve", half)
    _fails("contrast64.solve8")


def test_serve_half_batch(monkeypatch):
    from repro_torch.serve import engine
    real = engine._gather_program

    def half(state, rows):
        X, it, rr = real(state, rows)
        k = (X.shape[0] + 1) // 2
        X = torch.cat([X[:k], X[:k].mean(dim=0, keepdim=True)
                       .expand(X.shape[0] - k, -1)])
        return X, it, rr
    monkeypatch.setattr(engine, "_gather_program", half)
    _fails("uniform64.serve", rate=12.0)


# -- an answer altered where it is produced ----------------------------------

def test_factor_value_altered(monkeypatch):
    from repro_torch.core import parac
    real = parac._finalize_factor

    def altered(*a, **kw):
        f = real(*a, **kw)
        f.vals[0] = np.nextafter(f.vals[0], np.float32(1))
        return f
    monkeypatch.setattr(parac, "_finalize_factor", altered)
    line = _fails("uniform64.factor")
    assert line["checks"]["factor_mismatch"]["value"] >= 1


def test_solve_answer_altered(monkeypatch):
    from repro_torch.core.solver import PreconditionerHandle
    real = PreconditionerHandle.solve

    def altered(self, B, **kw):
        res = real(self, B, **kw)
        x = res.x.clone()
        x[0, 0] += 1.0
        return res._replace(x=x)
    monkeypatch.setattr(PreconditionerHandle, "solve", altered)
    _fails("contrast64.solve8")


def test_serve_answer_altered(monkeypatch):
    from repro_torch.serve import engine
    real = engine._gather_program

    def altered(state, rows):
        X, it, rr = real(state, rows)
        X = X.clone()
        X[0, 0] += 1.0
        return X, it, rr
    monkeypatch.setattr(engine, "_gather_program", altered)
    _fails("uniform64.serve")


def test_an_answer_not_a_number_fails(monkeypatch):
    """A NaN in one column is no number: the worst residual is not one
    either, and the run is not correct (a plain max would drop it)."""
    from repro_torch.core.solver import PreconditionerHandle
    real = PreconditionerHandle.solve

    def nan(self, B, **kw):
        res = real(self, B, **kw)
        x = res.x.clone()
        x[1, 0] = float("nan")
        return res._replace(x=x)
    monkeypatch.setattr(PreconditionerHandle, "solve", nan)
    line = _fails("contrast64.solve8")
    assert line["checks"]["resid_ratio"]["value"] == "nan"


def test_a_looser_tol_reads_more_iterations_gap():
    """The fault reading of the tools: the program solving to a looser tol
    than the configuration states, judged at the stated tol, falls short
    of the reference's iterations; at the stated tol it reads as a sound
    run."""
    from portbench.tools import controls
    cfg, _ = small(BENCH, "contrast64.solve8", side=8)

    def gap(tol):
        ((_, checks),) = controls.loose_tol_readings(
            BENCH, "contrast64.solve8", [SEED], tol, CPU, 0.5, config=cfg)
        return {c.name: c for c in checks}
    stated, loose = gap(cfg["solve"]["tol"]), gap(1e-4)
    assert all(c.ok for c in stated.values())
    assert loose["iters_gap"].value > stated["iters_gap"].value + 2
