"""The port's CLIP text tower and tokenizer against med_tpu's, and COG's
prompt tables built through them (fault C7: the port ignored a CLIP
checkpoint named by MED_TPU_CLIP_CKPT / MED_TPU_CLIP_BPE and built the
surrogate tables where med_tpu encodes the prompts).

Weights are drawn from a seed in the official state_dict layout (no CLIP
checkpoint is in the repository); the merges file is a tiny one whose rank
order matters. Tolerances: the towers agree to 1e-5 (float32 on the CPU,
sums in another order); tokenizations are equal.
"""

import random
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from med_tpu.models import clip_text as jclip
from med_tpu.models import clip_tokenizer as jtok
from med_tpu.models.cog import COG as JaxCOG
from med_tpu.models.prompts import load_prompt_embeddings as jax_load_prompts
from med_tpu_torch.models import clip_text as tclip
from med_tpu_torch.models import clip_tokenizer as ttok
from med_tpu_torch.models.cog import COG
from med_tpu_torch.models.prompts import (GESTURES, SKILL_STATEMENTS, encode_prompt_strings,
                                          load_prompt_embeddings)

TOL = 1e-5



class _QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class _Block(nn.Module):
    def __init__(self, d, h):
        super().__init__()
        self.attn = nn.MultiheadAttention(d, h)
        self.ln_1 = nn.LayerNorm(d)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(d, d * 4)), ("gelu", _QuickGELU()),
            ("c_proj", nn.Linear(d * 4, d))]))
        self.ln_2 = nn.LayerNorm(d)

    def forward(self, x, mask):
        h = self.ln_1(x)
        a, _ = self.attn(h, h, h, need_weights=False, attn_mask=mask)
        x = x + a
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, d, h, n_layers):
        super().__init__()
        self.resblocks = nn.ModuleList([_Block(d, h) for _ in range(n_layers)])


class _TextTower(nn.Module):
    """CLIP's text branch in the official key layout (model.py:343-358)."""

    def __init__(self, vocab, ctx, d, h, n_layers, embed=None):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab, d)
        self.positional_embedding = nn.Parameter(torch.empty(ctx, d))
        self.transformer = _Transformer(d, h, n_layers)
        self.ln_final = nn.LayerNorm(d)
        self.text_projection = nn.Parameter(torch.empty(d, embed or d))

    def forward(self, text):
        L = text.shape[1]
        x = self.token_embedding(text) + self.positional_embedding[:L]
        x = x.permute(1, 0, 2)
        mask = torch.full((L, L), float("-inf")).triu_(1)
        for blk in self.transformer.resblocks:
            x = blk(x, mask)
        x = self.ln_final(x.permute(1, 0, 2))
        return x[torch.arange(x.shape[0]), text.argmax(dim=-1)] @ self.text_projection


def _tower(seed, vocab=600, ctx=77, d=32, h=4, layers=2, embed=None):
    model = _TextTower(vocab, ctx, d, h, layers, embed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.04)
    return model.eval()


def _token_batch(rng, B, L, vocab):
    """tokenize-like rows: <sot> ids <eot> 0-pad; EOT = vocab-1 (largest)."""
    ids = np.zeros((B, L), np.int64)
    for r in range(B):
        n = int(rng.integers(3, L - 1))
        ids[r, 0] = vocab - 2
        ids[r, 1:n] = rng.integers(1, vocab - 2, n - 1)
        ids[r, n] = vocab - 1
    return ids


def _merges(tmp_path):
    """Merges whose rank order matters: (l,l) outranks (h,e)."""
    p = tmp_path / "merges.txt"
    p.write_text("#version: 0.2\nl l\nh e\ne l\ne d\ni n\nin g\n")
    return str(p)


def _port_encode(params, ids, n_heads):
    return tclip.encode_text(tclip.params_to(params, "cpu"), torch.from_numpy(ids),
                             n_heads=n_heads).numpy()


# ------------------------------------------------------------------ tokenizer
def test_tokenizer_goldens_through_the_port(tmp_path):
    """tests/test_clip_text.py's goldens: merge order, word-final symbols,
    case folding and white space, framing and truncation."""
    tok = ttok.ClipTokenizer(_merges(tmp_path))
    want = [tok.encoder["he"], tok.encoder["ll"], tok.encoder["o</w>"]]
    assert tok.encode("hello") == want
    assert tok.encode("xy") == [tok.encoder["x"], tok.encoder["y</w>"]]
    assert tok.encode("  HeLLo \n hello ") == want + want
    out = tok.tokenize(["hello", "hello hello hello"], context_length=6)
    sot, eot = tok.encoder[ttok.SOT], tok.encoder[ttok.EOT]
    he, ll, o = (tok.encoder[s] for s in ("he", "ll", "o</w>"))
    np.testing.assert_array_equal(out[0], [sot, he, ll, o, eot, 0])
    np.testing.assert_array_equal(out[1], [sot, he, ll, o, he, eot])
    assert eot == max(tok.encoder.values())


def test_tokenizer_equals_med_tpus_on_prompts_and_unicode(tmp_path):
    """The port splits words without the ``regex`` package: its ids equal
    med_tpu's (which uses it) on every COG prompt and on 3,000 seeded
    strings of ASCII, contractions, the special tokens, digits, other
    numerics and letters of other scripts."""
    merges = _merges(tmp_path)
    ours, theirs = ttok.ClipTokenizer(merges), jtok.ClipTokenizer(merges)
    skill = [f"A self-reported {s}-skilled surgeon is {g} ..."
             for s in ("novice", "intermediate", "expert") for g in GESTURES]
    rnd = random.Random(0)
    alphabet = (list("abc xyz'sStTrReEvVmMlLdD <|>startofendtext 0123 ½²Ⅻ éü日本語 \t\n"
                     "!?.,;:-_()[]&amp;") + [chr(rnd.randrange(0x20, 0x3000))
                                             for _ in range(300)])
    texts = list(GESTURES) + list(SKILL_STATEMENTS) + skill + [
        "".join(rnd.choice(alphabet) for _ in range(rnd.randrange(0, 40)))
        for _ in range(3000)]
    for text in texts:
        assert ours.encode(text) == theirs.encode(text), repr(text)
    np.testing.assert_array_equal(ours.tokenize(texts[:60]), theirs.tokenize(texts[:60]))


# ---------------------------------------------------------------------- tower
def test_encode_text_matches_med_tpu(rng):
    """2 layers of width 32 (4 heads): the port's tower against med_tpu's
    and the literal torch text branch, on one importer tree, to 1e-5."""
    vocab, ctx, d, h = 80, 16, 32, 4
    oracle = _tower(0, vocab, ctx, d, h)
    ids = _token_batch(rng, 6, ctx, vocab)
    params = tclip.import_clip_text(oracle.state_dict())
    jparams = jclip.import_clip_text(oracle.state_dict())
    assert jax.tree.structure(params) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    got = _port_encode(params, ids, h)
    want = np.asarray(jclip.encode_text(jparams, ids, n_heads=h))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    with torch.no_grad():
        literal = oracle(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, literal, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("fmt", ["state_dict", "jit", "npz"])
def test_load_clip_text_params_pt_jit_and_npz(tmp_path, rng, fmt):
    """A torch state_dict ``.pt``, a TorchScript archive (the official
    distribution's form) and an ``.npz`` of the same keys load to the tree
    med_tpu's loader reads from the same file."""
    vocab, ctx, d, h = 40, 12, 16, 2
    oracle = _tower(2, vocab, ctx, d, h)
    path = tmp_path / ("clip.npz" if fmt == "npz" else "clip.pt")
    if fmt == "state_dict":
        torch.save(oracle.state_dict(), path)
    elif fmt == "jit":
        torch.jit.save(torch.jit.trace(oracle, torch.zeros((1, ctx), dtype=torch.long)), path)
    else:
        np.savez(path, **{k: v.numpy() for k, v in oracle.state_dict().items()})
    params = tclip.load_clip_text_params(str(path))
    want = jclip.import_clip_text(oracle.state_dict())
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    ids = _token_batch(rng, 3, ctx, vocab)
    np.testing.assert_allclose(_port_encode(params, ids, h),
                               np.asarray(jclip.encode_text(want, ids, n_heads=h)),
                               rtol=TOL, atol=TOL)


# --------------------------------------------------------- C7: COG's tables
COG_VARIANTS = {"default": {}, "observed": dict(use_all_gestures=False),
                "skill_prompt": dict(use_skill_prompt=True), "srm": dict(srm=True)}


@pytest.fixture(scope="module")
def clip_files(tmp_path_factory):
    """A seeded tiny CLIP checkpoint (2 layers of width 32, context 77,
    projection to COG's 512) and a merges file."""
    root = tmp_path_factory.mktemp("clip")
    torch.save(_tower(5, embed=512).state_dict(), root / "clip.pt")
    return str(root / "clip.pt"), _merges(root)


@pytest.mark.parametrize("variant", sorted(COG_VARIANTS))
def test_cog_builds_med_tpus_prompt_tables_from_the_clip_variables(
        variant, clip_files, monkeypatch):
    """C7: with MED_TPU_CLIP_CKPT and MED_TPU_CLIP_BPE set, the port's COG
    buffers (``gest_embed``: 15, 8 or 45 rows; ``skill_embed`` under SRM)
    equal med_tpu's COG constants to 1e-5, and are CLIP encodings, not the
    surrogate table."""
    ckpt, bpe = clip_files
    monkeypatch.setenv("MED_TPU_CLIP_CKPT", ckpt)
    monkeypatch.setenv("MED_TPU_CLIP_BPE", bpe)
    kw = dict(num_layers_basic=3, num_layers_r=2, num_r=2, f_maps=16, f_dim=26,
              d_model=16, d_q=2, len_q=5, **COG_VARIANTS[variant])
    net = COG(**kw)
    jkw = dict(kw, use_pallas=False, fused=False)
    consts = JaxCOG(**jkw).init(jax.random.key(0), jnp.zeros((1, 32, 26)))["constants"]
    assert sorted(consts) == sorted(n for n, _ in net.named_buffers())
    rows = {"default": 15, "observed": 8, "skill_prompt": 45, "srm": 15}[variant]
    assert net.gest_embed.shape == (rows, 512)
    for name, table in consts.items():
        got = net.get_buffer(name).numpy()
        np.testing.assert_allclose(got, np.asarray(table), rtol=TOL, atol=TOL)
        texts = SKILL_STATEMENTS if name == "skill_embed" else None
        monkeypatch.delenv("MED_TPU_CLIP_CKPT")
        surrogate = load_prompt_embeddings(None, texts or GESTURES[:rows])
        monkeypatch.setenv("MED_TPU_CLIP_CKPT", ckpt)
        assert np.abs(got[: len(surrogate)] - surrogate).max() > 1.0


def test_prompt_loader_prefers_clip_and_checks_its_width(tmp_path, clip_files):
    """The arguments name the files as the variables do; a table file is
    ignored while CLIP is given; a tower of another width than asked raises,
    as med_tpu's loader does."""
    ckpt, bpe = clip_files
    texts = ("hello", "a novel skill-conditioned prompt: xy hello")
    table = tmp_path / "table.npy"
    np.save(table, np.zeros((2, 512), np.float32))
    got = load_prompt_embeddings(str(table), texts, clip_ckpt=ckpt, bpe_vocab=bpe)
    want = jax_load_prompts(str(table), texts, clip_ckpt=ckpt, bpe_vocab=bpe)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, encode_prompt_strings(ckpt, texts, bpe), rtol=0, atol=0)
    assert np.abs(got[0] - got[1]).max() > 1e-3
    with pytest.raises(ValueError, match="CLIP tower width 512"):
        load_prompt_embeddings(None, texts, dim=256, clip_ckpt=ckpt, bpe_vocab=bpe)
