"""The port's numpy copies of the data substrates (``repro_torch.data``)
against the JAX package's ``repro.data``: array-equal datasets, equal
tokenizer, oracle and proxy-LM outputs, equal metrics."""

import numpy as np
import pytest

import repro.data as jax_data
import repro_torch.data as data


@pytest.mark.parametrize("n,seed,grid", [(500, 0, 128), (301, 3, 64)])
def test_moons_dataset_equal(n, seed, grid):
    np.testing.assert_array_equal(data.moons_dataset(n, seed, grid),
                                  jax_data.moons_dataset(n, seed, grid))


@pytest.mark.parametrize("tier", ["pretty_good", "fair", "poor"])
def test_draft_tiers_equal(tier):
    np.testing.assert_array_equal(data.draft_tier_dataset(400, tier, seed=2),
                                  jax_data.draft_tier_dataset(400, tier, seed=2))
    with pytest.raises(ValueError):
        data.draft_tier_dataset(4, "great")


def test_symmetric_kl_equal():
    a = data.moons_dataset(800, 0)
    b = data.draft_tier_dataset(800, "fair", seed=1)
    assert data.symmetric_kl(a, b) == jax_data.symmetric_kl(a, b)
    assert data.symmetric_kl(a, a) == 0.0


def test_images_and_frechet_distance_equal():
    a = data.images_dataset(64, seed=0)
    np.testing.assert_array_equal(a, jax_data.images_dataset(64, seed=0))
    assert a.shape == (64, data.IMAGE_SEQ) and a.max() < 256
    b = data.images_dataset(64, seed=1)
    assert data.frechet_distance(a, b) == jax_data.frechet_distance(a, b)


def test_corpus_sequences_and_tokenizer_equal():
    corpus, jcorpus = data.SyntheticCorpus(seed=0), jax_data.SyntheticCorpus(seed=0)
    seqs = corpus.sequences(32, 48, seed=1)
    np.testing.assert_array_equal(seqs, jcorpus.sequences(32, 48, seed=1))
    np.testing.assert_array_equal(corpus.trans, jcorpus.trans)
    text = data.decode(seqs[0])
    assert text == jax_data.decode(seqs[0])
    np.testing.assert_array_equal(data.encode(text), jax_data.encode(text))
    np.testing.assert_array_equal(data.encode(text), seqs[0])
    assert data.CHARS == jax_data.CHARS and data.TEXT_VOCAB == jax_data.TEXT_VOCAB == 27


def test_word_oracle_and_proxy_lm_equal():
    """Drafts: corpus text with 30% of its letters replaced by other letters
    (spaces kept, so every fragment is at most a word long; see below)."""
    corpus, jcorpus = data.SyntheticCorpus(seed=0), jax_data.SyntheticCorpus(seed=0)
    rng = np.random.default_rng(0)
    drafts = corpus.sequences(6, 40, seed=4)
    hit = (drafts != 0) & (rng.random(drafts.shape) < 0.3)
    drafts = np.where(hit, rng.integers(1, 27, drafts.shape), drafts).astype(np.int32)
    refined = data.WordOracle(corpus)(drafts)
    np.testing.assert_array_equal(refined, jax_data.WordOracle(jcorpus)(drafts))
    assert refined.shape == drafts.shape and not np.array_equal(refined, drafts)
    train = corpus.sequences(64, 32, seed=2)
    lm, jlm = data.NGramProxyLM(order=3).fit(train), jax_data.NGramProxyLM(order=3).fit(train)
    held = corpus.sequences(8, 32, seed=3)
    assert lm.nll(held) == jlm.nll(held)
    assert lm.entropy(held) == jlm.entropy(held)


def test_word_oracle_long_fragment_fails_alike():
    """Reference fault R5 (ROADMAP): a fragment of 2 * 9 letters or more has
    no dictionary word within reach and ``_nearest_word`` indexes None. The
    copy keeps the reference's behaviour, so both raise."""
    drafts = np.full((1, 20), 1, np.int32)                  # "aaaa..." 20 letters
    for mod in (data, jax_data):
        with pytest.raises(TypeError):
            mod.WordOracle(mod.SyntheticCorpus(seed=0))(drafts)
