"""xLSTM (ssm) and Zamba2 (hybrid) on a (data, model) mesh of 4 gloo ranks
against the JAX package (``_torch_mesh_families``): the train step against
the reference's on 2x2 and 1x1, each rank's shards, the prefill and decode
bundles and the long-context decode bundle against one rank, the states'
layout, and no collective per time step.

Tolerances, each with its reason:

* the train step at float32 (one step, 2 micro-steps on 2x2): metrics
  within 1e-5 relative, both moments within 1e-4 of the leaf's largest
  entry -- float32 roundings summed in another order across shards; every
  parameter within 1e-4 of its leaf's largest entry where its gradient is
  at least ``GRAD_FLOOR`` (1e-5) of the leaf's largest, and within the
  step's bound (2 lr) below it: AdamW's first update lr g / (|g| + eps)
  is set by the roundings of a gradient near eps = 1e-8 (observed: the
  one-device port and the reference disagree there too, by 1.0e-4 to
  2.6e-4 of the leaf's largest, at |g| of 1e-9 to 4e-9);
* serving at float32 with float32 caches: logits within ``F32`` (rtol
  1e-4, atol 2e-4) of the one-rank run, every cache leaf within
  ``RECURRENT_CACHE`` (rtol 2**-7, atol 2e-4, test_torch_recurrent.py's:
  the float32 drift through the trunk; the states held at float32
  compute, C12);
* shard shapes: exact.
"""
import pytest

import _torch_mesh_families as fam

ARCHS = ("xlstm-1.3b", "zamba2-2.7b")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return fam.run_families(ARCHS, tmp_path_factory.mktemp("mesh_recurrent"))


@pytest.mark.parametrize("ref", ["1x1", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_2x2_matches_the_reference(runs, arch, ref):
    fam.check_train(runs, arch, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_local_shards_are_the_references_addressable_shards(runs, arch):
    fam.check_shards(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_bundles_on_2x2_match_one_rank(runs, arch):
    fam.check_serve(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_long_context_decode_bundle_matches_one_rank(runs, arch):
    """Batch 1, below the data axis: the recurrent states keep their heads
    over ``model`` and their batch whole (``_TRAILING``); Zamba2's shared
    attention cache shards its sequence over ``data``."""
    from torch.distributed.tensor import Replicate, Shard

    got, want = runs["ranks"][0][arch], runs["one"][arch]
    fam.close_logits(got["long"], want["long"])
    fam.close_caches(got["long_caches"], want["long_caches"], fam.RECURRENT_CACHE)
    pl = got["long_placements"]
    if arch == "zamba2-2.7b":
        assert pl["mamba.state"] == (Replicate(), Shard(2))  # [L, B, H, P, N]: heads
        assert pl["shared.k"] == (Shard(2), Shard(3))  # [n, B, S, KV, hd]: seq, heads
    else:
        assert pl["mlstm.c"] == (Replicate(), Shard(3))  # [G, k-1, B, H, P, P]
        assert pl["slstm.c"] == (Replicate(), Shard(2))  # [G, B, d_in]


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_states_keep_the_cache_layout(runs, arch):
    """The states a prefill and a decode step make come back on
    ``cache_pspecs``'s layout: batch over ``data``, heads over ``model``."""
    from torch.distributed.tensor import Shard

    pl = runs["ranks"][0][arch]["cache_placements"]
    if arch == "zamba2-2.7b":
        assert pl["mamba.state"] == (Shard(1), Shard(2))
        assert pl["mamba.conv"] == (Shard(1), Shard(3))
    else:
        assert pl["mlstm.n"] == (Shard(2), Shard(3))
        assert pl["slstm.h"] == (Shard(1), Shard(2))


@pytest.mark.parametrize("arch", ARCHS)
def test_a_prefill_runs_no_collective_per_time_step(runs, arch):
    """The recurrences run on each rank's rows with their weights whole
    (C16): a prefill of T tokens runs the same collectives as one of T/2."""
    short, long_ = runs["ranks"][0][arch]["prefill_counts"]
    assert short == long_ and sum(short.values()) > 0, (short, long_)
