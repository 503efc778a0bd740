"""The cases of ``tests/test_torch_pipeline_models.py`` at pp=4 on 4 gloo
ranks (one stage a rank, the middle stages neither embedding nor head),
against the JAX package's pipelined models at 4 stages on a pp=4 mesh:
the loss and every leaf's gradient, the evaluation forward's logits, and
each rank's block of the tables."""

import pytest

from test_torch_pipeline_models import (
    IDS,
    check_eval_logits,
    check_loss_and_every_grad,
    check_table_blocks,
    run_cases,
)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    S = 4
    return (S, *run_cases(S, tmp_path_factory.mktemp("pp4")))


@pytest.mark.parametrize("cid", IDS)
def test_loss_and_every_grad_match_jax_at_pp4(run, cid):
    check_loss_and_every_grad(run, cid)


@pytest.mark.parametrize("cid", [c for c in IDS if "interleaved" not in c])
def test_eval_forward_matches_jax_logits_at_pp4(run, cid):
    check_eval_logits(run, cid)


@pytest.mark.parametrize("cid", IDS)
def test_tables_are_cut_over_pp4_alone(run, cid):
    check_table_blocks(run, cid)


def test_every_rank_is_a_stage(run):
    _, ranks, _, _ = run
    assert [(r["coords"]["dp"], r["coords"]["pp"]) for r in ranks] == [
        (0, s) for s in range(4)]
