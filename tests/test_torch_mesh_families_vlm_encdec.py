"""InternVL2 (vlm) and SeamlessM4T (encdec) on a (data, model) mesh of 4
gloo ranks against the JAX package (``_torch_mesh_families``): the train
step against the reference's on 2x2 and 1x1, each rank's shards, and the
prefill and decode bundles against one rank.  The vlm's patch prefix runs
on a batch-sharded input; the encoder-decoder's encoder, its decoder's
cross-attention to a batch-sharded ``enc_out`` and its ``enc_out`` cache
(``("batch", None, None)``) run on DTensors.

Tolerances, each with its reason:

* the train step at float32 (one step, 2 micro-steps on 2x2): metrics
  within 1e-5 relative, both moments within 1e-4 of the leaf's largest
  entry -- float32 roundings summed in another order across shards; every
  parameter within 1e-4 of its leaf's largest entry where its gradient is
  at least ``GRAD_FLOOR`` (1e-5) of the leaf's largest, and within the
  step's bound (2 lr) below it (AdamW's first update is set by the
  roundings of a gradient near eps: see the recurrent file);
* serving at float32 with float32 caches: logits within ``F32`` (rtol
  1e-4, atol 2e-4) of the one-rank run, caches within ``CACHE`` (rtol
  2**-7, atol 1e-6);
* shard shapes: exact.
"""
import pytest

import _torch_mesh_families as fam

ARCHS = ("internvl2-26b", "seamless-m4t-large-v2")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return fam.run_families(ARCHS, tmp_path_factory.mktemp("mesh_vlm_encdec"))


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


def test_the_enc_out_cache_keeps_its_layout(runs):
    """``enc_out`` [B, S, d] over the batch alone, ``enc_len`` replicated,
    the self-attention caches' heads over ``model``."""
    from torch.distributed.tensor import Replicate, Shard

    pl = runs["ranks"][0]["seamless-m4t-large-v2"]["cache_placements"]
    assert pl["enc_out"] == (Shard(0), Replicate())
    assert pl["enc_len"] == (Replicate(), Replicate())
    assert pl["layers.k"] == (Shard(1), Shard(3))
