"""``correct`` comes out false for the control and for each fault the cells
can have, with the timed path broken underneath a whole run (the look for
a card skipped: the tiny cell on the CPU)."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from conftest import TINY_CELL

from atlas_bench import cells, control, harness


def _run(root, seed=2 ** 31 + 21):
    cell = cells.find(root, TINY_CELL)
    return harness.run(cell, seed, 0.5, False, torch.device("cpu"), 0.0)


@pytest.fixture
def broken(monkeypatch):
    """Replace AtlasProver.prove by ``fault(real_prove, self, inputs)``."""
    from jolt_atlas_tpu_torch.prover import AtlasProver
    real = AtlasProver.prove

    def install(fault):
        monkeypatch.setattr(AtlasProver, "prove",
                            lambda self, ins: fault(real, self, ins))
    return install


def test_the_control_is_not_correct(tiny_root):
    cell = cells.find(tiny_root, TINY_CELL)
    with control.in_program_place(cell, 2 ** 31 + 21, torch.device("cpu"),
                                  1):
        out = harness.run(cell, 2 ** 31 + 21, 0.5, False,
                          torch.device("cpu"), 0.0)
    assert not out["correct"]
    assert out["checks"]["io_mismatch"]["value"] > 0


def test_an_answer_altered_where_it_is_produced(tiny_root, broken):
    def fault(real, self, ins):
        proof, (pin, pout) = real(self, ins)
        out = pout[0].copy()
        out[0, 0] += 1
        return proof, (pin, [out])
    broken(fault)
    out = _run(tiny_root)
    assert not out["correct"]
    assert out["checks"]["io_mismatch"]["value"] >= out["attempted"]


def test_a_proof_altered_where_it_is_produced(tiny_root, broken):
    def fault(real, self, ins):
        proof, io = real(self, ins)
        claims = dict(proof.opening_claims)
        key = sorted(claims, key=repr)[0]
        claims[key] = claims[key] + type(claims[key])(1)
        return dataclasses.replace(proof, opening_claims=claims), io
    broken(fault)
    out = _run(tiny_root)
    assert not out["correct"]
    assert out["checks"]["rejected"]["value"] == out["attempted"]


def test_a_stale_answer_for_a_new_request(tiny_root, broken):
    first = {}

    def fault(real, self, ins):
        # the state left unchanged: every request gets the first answer
        # (after a pause, so that the window holds a few requests)
        if "answer" not in first:
            first["answer"] = real(self, ins)
        time.sleep(0.2)
        return first["answer"]
    broken(fault)
    out = _run(tiny_root)
    assert not out["correct"]
    assert out["checks"]["rejected"]["value"] >= 1
    assert out["checks"]["io_mismatch"]["value"] >= 1


def test_a_request_that_raises_fails_the_run(tiny_root, broken):
    calls = []

    def fault(real, self, ins):
        calls.append(1)
        if len(calls) == 2:  # the first window request; 1 is the warm-up
            raise RuntimeError("a planted fault")
        return real(self, ins)
    broken(fault)
    out = _run(tiny_root)
    assert not out["correct"] and out["failed"] == 1
    assert np.isfinite(out["metrics"]["prove_s"]["value"])
