"""Port vs reference: configs, tokenizer, corpus and the bag embedder.

Configs, tokens and corpora are held exact; ``bag_embed`` to atol 1e-6
(the two packages' f32 ``erfinv`` differ in the last bits).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as R_cfg  # noqa: E402
from repro.data import corpus as R_corpus  # noqa: E402
from repro.data import tokenizer as R_tok  # noqa: E402
from repro.data.embeddings import bag_embed as r_bag_embed  # noqa: E402
from repro_torch import configs as T_cfg  # noqa: E402
from repro_torch.data import corpus as T_corpus  # noqa: E402
from repro_torch.data import tokenizer as T_tok  # noqa: E402
from repro_torch.data.embeddings import bag_embed, token_vectors  # noqa: E402


@pytest.mark.parametrize("name", sorted(R_cfg._MODULES))
def test_configs_equal_field_by_field(name):
    r, t = R_cfg.get_config(name), T_cfg.get_config(name)
    assert dataclasses.asdict(r) == dataclasses.asdict(t)
    assert dataclasses.asdict(R_cfg.smoke_config(r)) == dataclasses.asdict(T_cfg.smoke_config(t))
    assert r.n_blocks == t.n_blocks and r.param_count() == t.param_count()


def test_tokenizer_and_corpus_exact():
    texts = ["what is attr3 of entity7", "Pubmedword1 pubmedword2 is value9x42 .", ""]
    for v in (256, 8192):
        rt, tt = R_tok.HashTokenizer(v), T_tok.HashTokenizer(v)
        for s in texts:
            assert np.array_equal(rt.encode(s), tt.encode(s))
            assert np.array_equal(rt.encode(s, max_len=12), tt.encode(s, max_len=12))
        a, b = rt.encode_pair(texts[0], texts[1], 16), tt.encode_pair(texts[0], texts[1], 16)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    rc = R_corpus.make_federated_corpus(n_facts=40, n_distractors=30, n_queries=20, seed=5)
    tc = T_corpus.make_federated_corpus(n_facts=40, n_distractors=30, n_queries=20, seed=5)
    assert [dataclasses.asdict(c) for c in rc.chunks] == [dataclasses.asdict(c) for c in tc.chunks]
    assert [dataclasses.asdict(q) for q in rc.queries] == [dataclasses.asdict(q) for q in tc.queries]


def test_bag_embed_matches_reference():
    # the port reproduces the partitionable threefry bit stream, JAX's default
    assert jax.config.jax_threefry_partitionable
    ids = np.arange(0, 8192, 7)
    ref_vecs = jax.vmap(
        lambda t: jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(17), t), (64,), jnp.float32)
    )(jnp.asarray(ids))
    got = token_vectors(torch.as_tensor(ids), 64).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_vecs), rtol=1e-5, atol=1e-5)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 8192, size=(48, 40)).astype(np.int32)
    toks[:, 25:] = 0  # PAD tail
    toks[3] = 0  # an all-PAD row pools to zero
    a = bag_embed(toks, device="cpu").numpy()
    b = np.asarray(r_bag_embed(jnp.asarray(toks)))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_bag_embed_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bag_embed(np.zeros((1, 4), np.int32))
