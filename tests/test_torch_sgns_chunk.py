"""The word2vec chunk step's kernel chain (``ops/sgns.py``,
``csrc/sgns.cu``) against its plain version, and the block step built on
it.

The tests marked ``card`` need a CUDA card and skip here; on the card,
where there is no JAX, run them without this directory's conftest:
``python -m pytest --noconftest -q tests/test_torch_sgns_chunk.py``. The
others run on the CPU, where the wrapper takes the plain version. This
file imports no JAX: the block step's comparisons with the JAX package
are in ``test_torch_word2vec.py`` and ``test_torch_w2v_deterministic.py``.
"""

import numpy as np
import pytest
import torch

from multiverso_tpu_torch.models import word2vec as tw
from multiverso_tpu_torch.models.vocab import Dictionary
from multiverso_tpu_torch.ops import sgns
from multiverso_tpu_torch.ops.sampling import unigram_negative_sampler

FIELDS = ("ids_in", "d_in", "ids_out", "d_out", "ids_neg", "d_neg", "loss",
          "pairs")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU version")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's einsums
    return torch.device("cuda", 0)


def _counts(vocab):
    return (1e7 / np.arange(1, vocab + 1)).astype(np.int64) + 5


def _zipf_block(rng, t, vocab, tail=0):
    """Zipf tokens (many duplicate ids), a few masked inside, ``tail``
    padded at the end."""
    p = 1.0 / np.arange(1, vocab + 1)
    block = rng.choice(vocab, t, p=p / p.sum()).astype(np.int32)
    block[t // 3:t // 3 + 4] = -1
    if tail:
        block[-tail:] = -1
    return block


def _chunk_inputs(rng, t, dim, window, k, group, rows_in, rows_out, vocab,
                  neg_table, tail=0, device="cpu"):
    """Tables, a chunk and its draws. Rows past ``vocab`` stay zero, the
    last one the sentinel; with ``neg_table`` the negatives are indices
    into a 16,384-slot table of rows."""
    w_in = torch.zeros((rows_in, dim), dtype=torch.float32, device=device)
    w_out = torch.zeros((rows_out, dim), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 30)))
    w_in[:vocab].uniform_(-0.5, 0.5, generator=gen)
    w_out[:vocab].uniform_(-0.5, 0.5, generator=gen)
    block = torch.from_numpy(_zipf_block(rng, t, vocab, tail)).to(device)
    win = torch.from_numpy(rng.integers(1, window + 1, t)).to(device)
    slots = None
    if neg_table:
        slots = torch.from_numpy(
            rng.integers(0, vocab, 16384).astype(np.int32)).to(device)
        neg = rng.integers(0, 16384, (t // group, k))
    else:
        neg = rng.integers(0, vocab, (t // group, k))
    return w_in, w_out, block, win, torch.from_numpy(neg).to(device), slots


def _kw(window, k, group, combine, cap=1.0):
    return dict(window=window, negatives=k, group=group, combine=combine,
                max_row_step=cap)


# -- the CPU: the wrapper takes the plain version --------------------------------

@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("neg_table", [False, True])
def test_cpu_wrapper_is_the_plain_version(combine, neg_table):
    """On the CPU the wrapper returns the plain version's arrays, bit for
    bit, and launches nothing."""
    rng = np.random.default_rng(3)
    args = _chunk_inputs(rng, 256, 16, 3, 4, 4, 301, 301, 300, neg_table,
                         tail=20)
    before = sgns.sgns_chunk.launches
    got = sgns.sgns_chunk(*args, 0.2, **_kw(3, 4, 4, combine, 0.5))
    want = sgns.sgns_chunk_plain(*args, 0.2, **_kw(3, 4, 4, combine, 0.5))
    assert sgns.sgns_chunk.launches == before
    for name, a, b in zip(FIELDS, got, want):
        assert torch.equal(a, b), name
    assert float(got.pairs) > 0


def _bad(case):
    """A well-formed argument set with one thing wrong."""
    rng = np.random.default_rng(0)
    w_in, w_out, block, win, neg, slots = _chunk_inputs(
        rng, 64, 8, 2, 3, 4, 51, 51, 50, True)
    kw = _kw(2, 3, 4, "sum")
    if case == "table_dtype":
        w_in = w_in.double()
    elif case == "table_dims":
        w_out = w_out.reshape(-1)
    elif case == "widths":
        w_out = torch.zeros((51, 9))
    elif case == "group":
        kw["group"] = 3
    elif case == "block_dtype":
        block = block.float()
    elif case == "block_dims":
        block = block.reshape(8, 8)
    elif case == "win_shape":
        win = win[:32]
    elif case == "neg_shape":
        neg = neg[:, :2]
    elif case == "neg_dtype":
        neg = neg.float()
    elif case == "slots_dtype":
        slots = slots.float()
    elif case == "combine":
        kw["combine"] = "max"
    elif case == "negatives":
        kw["negatives"] = -1
    return (w_in, w_out, block, win, neg, slots, 0.1), kw


@pytest.mark.parametrize("case", [
    "table_dtype", "table_dims", "widths", "group", "block_dtype",
    "block_dims", "win_shape", "neg_shape", "neg_dtype", "slots_dtype",
    "combine", "negatives"])
def test_wrapper_checks_raise(case):
    """What the kernels do not take raises ValueError before anything runs,
    on the CPU as on the card."""
    args, kw = _bad(case)
    before = sgns.sgns_chunk.launches
    with pytest.raises(ValueError, match="sgns_chunk"):
        sgns.sgns_chunk(*args, **kw)
    assert sgns.sgns_chunk.launches == before


def test_group_of_one_and_the_whole_chunk():
    """group 1 (a negative set a centre) and group T (one for the chunk)
    both run; every centre of a live group shares the group's rows."""
    rng = np.random.default_rng(5)
    for group in (1, 64):
        args = _chunk_inputs(rng, 64, 8, 2, 3, group, 41, 41, 40, False)
        c = sgns.sgns_chunk(*args, 0.1, **_kw(2, 3, group, "sum"))
        assert c.ids_neg.shape == (64 // group * 3,)
        assert c.d_neg.shape == (64 // group * 3, 8)
        assert torch.isfinite(c.loss)


def _plain_block_step(config, neg_table, sampler):
    """What the block step is, spelled out: its draws by the same calls,
    the plain version's deltas, then the three scatters."""
    window, negatives, G = config.window, config.negatives, config.neg_sharing
    kw = dict(window=window, negatives=negatives, group=G,
              combine=config.grad_combine, max_row_step=config.max_row_step)

    def step(params, generator, block, lr, neg_slots=None, with_pairs=False,
             draws=None):
        w_in, w_out = params["w_in"], params["w_out"]
        dev = w_in.device
        t = block.shape[0]
        tg = t // G
        if draws is not None:
            b = tw._as_index(draws["win"], dev)
            neg = tw._as_index(draws["neg"], dev)
        else:
            b = torch.randint(1, window + 1, (t,), generator=generator,
                              device=dev)
            neg = (torch.randint(0, neg_slots.shape[0], (tg, negatives),
                                 generator=generator, device=dev)
                   if neg_table else sampler((tg, negatives), generator))
        c = sgns.sgns_chunk_plain(w_in, w_out, block.to(dev), b, neg,
                                  neg_slots if neg_table else None, lr, **kw)
        tw._add_rows(w_in, c.ids_in, c.d_in, False)
        tw._add_rows(w_out, c.ids_out, c.d_out, False)
        tw._add_rows(w_out, c.ids_neg, c.d_neg, False)
        if with_pairs:
            return params, c.loss, c.pairs
        return params, c.loss

    return step


@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("neg_table,G", [(False, 1), (False, 4), (True, 2),
                                         (True, 8)])
@pytest.mark.parametrize("drawn", ["generator", "injected"])
def test_block_step_bit_equal_to_the_eager_step(combine, neg_table, G, drawn):
    """The block step on the CPU, three chunks in a row, gives the tables,
    losses and pair counts of its draws, the plain version and the three
    scatters bit for bit, with its own generator's draws and with injected
    ones (the JAX comparisons of ``test_torch_word2vec.py`` pin the
    arithmetic)."""
    vocab, t = 120, 128
    cfg = tw.Word2VecConfig(vocab_size=vocab, dim=12, window=3, negatives=4,
                            block_tokens=t, neg_sharing=G, grad_combine=combine,
                            max_row_step=0.8, sample=0.0)
    d = Dictionary()
    d.counts = _counts(vocab)
    step = tw.make_block_train_step(cfg, d, neg_table=neg_table, device="cpu")
    plain = _plain_block_step(cfg, neg_table,
                              unigram_negative_sampler(d.counts, device="cpu"))
    rng = np.random.default_rng(9)
    rows = 90 if neg_table else vocab + 1
    w0, u0 = (torch.from_numpy(rng.standard_normal((rows, 12)).astype(
        np.float32)) * 0.3 for _ in range(2))
    params = [{"w_in": w0.clone(), "w_out": u0.clone()} for _ in range(2)]
    slots = (torch.from_numpy(rng.integers(0, rows - 1, 300).astype(np.int32))
             if neg_table else None)
    gens = [torch.Generator().manual_seed(4) for _ in range(2)]
    for i in range(3):
        block = torch.from_numpy(_zipf_block(rng, t, rows - 1,
                                             tail=30 if i == 2 else 0))
        draws = None
        if drawn == "injected":
            draws = {"win": rng.integers(1, 4, t),
                     "neg": rng.integers(0, 300 if neg_table else rows - 1,
                                         (t // G, 4))}
        outs = [fn(p, gen, block, 0.3, slots, with_pairs=True, draws=draws)
                for fn, p, gen in zip((step, plain), params, gens)]
        (p1, l1, n1), (p2, l2, n2) = outs
        assert torch.equal(l1, l2) and torch.equal(n1, n2)
    for name in ("w_in", "w_out"):
        assert torch.equal(params[0][name], params[1][name]), name


# -- the card ----------------------------------------------------------------------

# float32 sums in another order: a score is a 300-term dot product and a
# delta a sum of at most 2W + K (or G) of them, so the kernels and the
# eager version (cuBLAS and PyTorch's reductions) part by float32 rounding
# in the last few bits of each term, relative to the array's scale
DELTA_RTOL, DELTA_ATOL_SCALE = 1e-4, 1e-5
LOSS_RTOL = 1e-5

BENCH = dict(t=8192, window=5, k=5, group=8)


def _close_chunks(got, want):
    for name in ("ids_in", "ids_out", "ids_neg", "pairs"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for name in ("d_in", "d_out", "d_neg"):
        a, b = getattr(got, name), getattr(want, name)
        torch.testing.assert_close(
            a, b, rtol=DELTA_RTOL,
            atol=DELTA_ATOL_SCALE * float(b.abs().max().clamp(min=1e-30)),
            msg=lambda m: f"{name}: {m}")
    torch.testing.assert_close(got.loss, want.loss, rtol=LOSS_RTOL, atol=0.0)


@pytest.mark.card
@pytest.mark.parametrize("dim", [300, 128])
@pytest.mark.parametrize("rows,neg_table", [(3_000_001, False),
                                            (180_000, True)])
@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("tail", [0, 3000])
def test_kernels_match_plain_at_the_bench_shape(card, dim, rows, neg_table,
                                                combine, tail):
    """The chain against the plain version on the card at the benchmark's
    chunk: 3,000,001 rows with unigram negatives (the device trainer) and a
    180,000-row compact space with the slot table (the PS transaction),
    zipf tokens with duplicates, a padded tail, injected draws."""
    rng = np.random.default_rng(dim + rows + len(combine) + tail)
    vocab = min(rows - 1, 100_000)
    args = _chunk_inputs(rng, BENCH["t"], dim, BENCH["window"], BENCH["k"],
                         BENCH["group"], rows, rows, vocab, neg_table, tail,
                         device=card)
    kw = _kw(BENCH["window"], BENCH["k"], BENCH["group"], combine, 0.05)
    got = sgns.sgns_chunk(*args, 0.025, **kw)
    want = sgns.sgns_chunk_plain(*args, 0.025, **kw)
    torch.cuda.synchronize()
    _close_chunks(got, want)
    assert float(got.pairs) > 0


@pytest.mark.card
@pytest.mark.parametrize("dim,stride", [(30, 30), (300, 304), (13, 16)])
def test_kernels_match_plain_scalar_and_strided_rows(card, dim, stride):
    """Widths that are not whole float4 vectors take the scalar path; rows
    with a stride past their width (a padded table's columns) are read in
    place."""
    rng = np.random.default_rng(dim)
    w_in, w_out, block, win, neg, slots = _chunk_inputs(
        rng, 2048, stride, 5, 5, 8, 20_001, 20_001, 20_000, True, 100,
        device=card)
    w_in, w_out = w_in[:, :dim], w_out[:, :dim]
    kw = _kw(5, 5, 8, "sum")
    got = sgns.sgns_chunk(w_in, w_out, block, win, neg, slots, 0.025, **kw)
    want = sgns.sgns_chunk_plain(w_in, w_out, block, win, neg, slots, 0.025,
                                 **kw)
    torch.cuda.synchronize()
    _close_chunks(got, want)


@pytest.mark.card
@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_kernels_are_deterministic_and_count_launches(card, combine):
    """Two runs on the same inputs give the same bits (the only float
    atomics add whole-number counts), int32 and int64 draws read the same,
    and each chunk adds ``KERNELS`` launches."""
    rng = np.random.default_rng(1)
    args = _chunk_inputs(rng, 8192, 300, 5, 5, 8, 180_000, 180_000, 170_000,
                         True, 500, device=card)
    kw = _kw(5, 5, 8, combine)
    before = sgns.sgns_chunk.launches
    a = sgns.sgns_chunk(*args, 0.025, **kw)
    b = sgns.sgns_chunk(*args, 0.025, **kw)
    w_in, w_out, block, win, neg, slots = args
    c = sgns.sgns_chunk(w_in, w_out, block.long(), win.int(), neg.int(),
                        slots.long(), 0.025, **kw)
    torch.cuda.synchronize()
    assert sgns.sgns_chunk.launches == before + 3 * sgns.KERNELS
    for name, x, y, z in zip(FIELDS, a, b, c):
        assert torch.equal(x, y), name
        assert torch.equal(x, z), name


@pytest.mark.card
def test_block_step_on_the_card_goes_through_the_kernels(card):
    """The block step on a CUDA table takes the kernels on every chunk,
    and three chunks of it match three of the eager step from the same
    start and draws."""
    vocab, t = 50_000, 8192
    cfg = tw.Word2VecConfig(vocab_size=vocab, dim=128, window=5, negatives=5,
                            block_tokens=t, neg_sharing=8, sample=0.0)
    d = Dictionary()
    d.counts = _counts(vocab)
    step = tw.make_block_train_step(cfg, d, device=card)
    plain = _plain_block_step(cfg, False, None)
    rng = np.random.default_rng(2)
    w = torch.empty((vocab + 1, 128), device=card).uniform_(-0.3, 0.3)
    u = torch.empty((vocab + 1, 128), device=card).uniform_(-0.3, 0.3)
    params = [{"w_in": w.clone(), "w_out": u.clone()} for _ in range(2)]
    before = sgns.sgns_chunk.launches
    for i in range(3):
        block = torch.from_numpy(_zipf_block(rng, t, vocab)).to(card)
        draws = {"win": rng.integers(1, 6, t),
                 "neg": rng.integers(0, vocab, (t // 8, 5))}
        (_, l1, n1), (_, l2, n2) = [
            fn(p, None, block, 0.025, with_pairs=True, draws=draws)
            for fn, p in zip((step, plain), params)]
        assert torch.equal(n1, n2)
        torch.testing.assert_close(l1, l2, rtol=LOSS_RTOL, atol=0.0)
    assert sgns.sgns_chunk.launches == before + 3 * sgns.KERNELS
    for name in ("w_in", "w_out"):
        a, b = params[0][name], params[1][name]
        torch.testing.assert_close(a, b, rtol=DELTA_RTOL, atol=1e-6)


@pytest.mark.card
def test_card_wrapper_refuses_strided_draws(card):
    """The kernels read the draws in place: a strided tensor raises."""
    rng = np.random.default_rng(0)
    w_in, w_out, block, win, neg, slots = _chunk_inputs(
        rng, 64, 8, 2, 3, 4, 51, 51, 50, True, device=card)
    wide = torch.stack([win, win], dim=1)[:, 0]
    with pytest.raises(ValueError, match="contiguous"):
        sgns.sgns_chunk(w_in, w_out, block, wide, neg, slots, 0.1,
                        **_kw(2, 3, 4, "sum"))
