"""The launch plans of the port's redesigned kernels:
``feature_map.rff_plan`` (tile of ``rff_features``),
``decision.decision_plan`` (tile and SV-axis split of ``decision`` /
``multitask_decision``), ``flash_attn.flash_plan`` (query tiles, ring,
heaviest tile first) and ``ssd_diag.ssd_plan`` (head groups, query
tiles, ring). Plain Python, so they are held here, on the CPU; the
kernels they configure run in tests/test_torch_cuda.py, which refuse a
plan whose shared memory differs from their own count."""
import math

import pytest
import torch

from repro_torch.kernels import decision as D
from repro_torch.kernels import feature_map as FM
from repro_torch.kernels import flash_attn as FA
from repro_torch.kernels import ssd_diag as SD
from repro_torch.kernels import tile_f32

SMS = tile_f32.H100_SMS
MAX_SMEM = 232448   # bytes of shared memory an H100 block may opt in to


@pytest.mark.parametrize("n,k,rows", [
    (29491, 1024, 128),   # the low-rank fit: 231 x 8 = 1,848 blocks
    (2177, 1023, 128),    # 18 x 8 = 144 128-row tiles: one wave
    (1024, 1024, 64),     # a serving batch: 8 x 8 = 64 128-row tiles
    (1025, 1023, 64),     # 9 x 8 = 72
    (1, 1, 64)])
def test_rff_tile_is_chosen_by_grid_size(n, k, rows):
    plan = FM.rff_plan(n, k, 102)
    assert plan.rows == rows
    assert (math.ceil(n / 128) * math.ceil(k / FM.COLS) >= SMS) == (
        rows == 128)
    assert plan.blocks == math.ceil(n / rows) * math.ceil(k / FM.COLS)


@pytest.mark.parametrize("d,chunk,stages", [
    (1, 4, 1), (4, 4, 1), (102, 104, 1), (128, 128, 1), (129, 64, 2),
    (300, 64, 2), (4096, 64, 2)])
def test_rff_features_resident_up_to_128_then_chunked(d, chunk, stages):
    """Whole feature axis staged once up to RES_WIDTH, a two-stage ring
    of 64-feature chunks past it; the shared memory always fits."""
    for rows_n in (29491, 1):
        plan = FM.rff_plan(rows_n, 1024, d)
        assert plan.chunk == chunk
        assert plan.smem_bytes == stages * 4 * (
            plan.rows * tile_f32.row_stride(chunk) + chunk * FM.COLS)
        assert plan.smem_bytes <= MAX_SMEM


def test_rff_features_two_blocks_an_sm_at_svm_width():
    """At the paper's 102 bands a 128 x 128 block takes ~106 KB: two fit
    the SM's 228 KB (1 KB of it reserved per block)."""
    plan = FM.rff_plan(29491, 1024, 102)
    assert 2 * (plan.smem_bytes + 1024) <= 233472


@pytest.mark.parametrize("width", [1, 4, 17, 64, 102, 128, 300])
def test_row_stride_keeps_float4_rows_conflict_free(width):
    ld = tile_f32.row_stride(width)
    assert ld % 4 == 0 and (ld // 4) % 2 == 1 and width <= ld <= width + 7
    # 8 threads reading a float4 each from 8 consecutive rows at one
    # offset touch 32 different banks
    banks = {(r * ld + c) % 32 for r in range(8) for c in range(4)}
    assert len(banks) == 32


@pytest.mark.parametrize("nt,tasks,w", [
    (29491, 1, 1000), (3686, 6, 986), (8448, 1, 17), (4096, 9, 3792)])
def test_no_split_when_the_grid_fills_the_card(nt, tasks, w):
    plan = D.decision_plan(nt, tasks, w, 102)
    assert math.ceil(nt / plan.rows) * tasks >= SMS
    assert plan.splits == 1


@pytest.mark.parametrize("nt,tasks,w", [
    (1024, 6, 986), (1024, 9, 3792), (1, 9, 3792), (1, 36, 1413),
    (512, 2, 1500), (512, 2, 3792), (37, 1, 3277)])
def test_split_when_the_grid_leaves_sms_idle(nt, tasks, w):
    plan = D.decision_plan(nt, tasks, w, 102)
    blocks = math.ceil(nt / plan.rows) * tasks
    assert blocks < SMS and plan.splits > 1
    assert plan.blocks == blocks * plan.splits


@pytest.mark.parametrize("nt", [1, 37, 64, 65, 1024, 3277])
@pytest.mark.parametrize("tasks", [1, 3, 36])
@pytest.mark.parametrize("w", [1, 17, 64, 65, 986, 3792])
def test_splits_never_exceed_the_sv_tiles(nt, tasks, w):
    plan = D.decision_plan(nt, tasks, w, 102)
    assert 1 <= plan.splits <= plan.segments <= math.ceil(w / D.SV_TILE)
    assert plan.rows in (64, 128)
    assert plan.rows == 64 or nt > 64      # one-row serving: 64-row tile


def test_split_is_the_cheapest_under_the_cost_model():
    """The OvO bank (6 x 986 SVs over 1,024 rows, 48 row-tile blocks):
    no other split is cheaper, and the chosen grid has more blocks than
    SMs, so none idles for want of work."""
    plan = D.decision_plan(1024, 6, 986, 102)
    tiles = math.ceil(986 / D.SV_TILE)
    assert (plan.seg, plan.segments) == (1, tiles)
    costs = [D._split_cost(48, s, tiles, 1, SMS) for s in range(1, tiles + 1)]
    assert D._split_cost(48, plan.splits, tiles, 1, SMS) == min(costs)
    assert plan.blocks >= SMS


@pytest.mark.parametrize("d,chunk", [(3, 4), (102, 104), (128, 128),
                                     (129, 64), (300, 64)])
def test_decision_shared_memory_fits(d, chunk):
    for nt in (1, 1024, 29491):
        plan = D.decision_plan(nt, 6, 986, d)
        assert plan.chunk == chunk
        assert plan.smem_bytes <= MAX_SMEM


def _cuda_smem_bytes(bm: int, chunk: int, nch: int, sv_bytes: int) -> int:
    """``smem_bytes`` of csrc/decision.cu, mirrored: the float32 test-row
    tile (two when the features come in chunks), the norms, four running
    sums a row, and two SV stages at the bank's element size."""
    ld = tile_f32.row_stride(chunk)
    return (4 * ((1 if nch == 1 else 2) * bm * ld + bm + D.SV_TILE + 4 * bm)
            + 2 * D.SV_TILE * ld * sv_bytes)


BANKS = {torch.float32: 4, torch.float16: 2, torch.bfloat16: 2}


@pytest.mark.parametrize("bank", list(BANKS), ids=["fp32", "fp16", "bf16"])
@pytest.mark.parametrize("d", [3, 7, 36, 64, 102, 128, 129, 300])
def test_decision_shared_memory_is_the_cuda_count(bank, d):
    """Whatever the bank's dtype, tile and split, the plan's shared
    memory is the kernel's own count (it refuses any other) and fits an
    H100 block; a 16-bit bank's SV stages take half a float32 bank's."""
    for nt, tasks, w in ((1, 6, 986), (1024, 6, 986), (1024, 3, 3792),
                         (29491, 1, 17)):
        for rows in (64, 128):
            plan = D.plan_with(nt, tasks, w, d, rows, 1, bank)
            nch = math.ceil(math.ceil(d / 4) * 4 / plan.chunk)
            assert plan.smem_bytes == _cuda_smem_bytes(rows, plan.chunk,
                                                       nch, BANKS[bank])
            assert plan.smem_bytes <= MAX_SMEM
            fp32 = D.plan_with(nt, tasks, w, d, rows, 1)
            assert fp32.smem_bytes - plan.smem_bytes == (
                2 * D.SV_TILE * tile_f32.row_stride(plan.chunk)
                * (4 - BANKS[bank]))
            assert plan._replace(smem_bytes=0) == fp32._replace(smem_bytes=0)


@pytest.mark.parametrize("nt,tasks,w,rows,splits,smem", [
    (1024, 6, 986, 128, 8, 113408),    # the largest served OvO bank
    (1024, 3, 3792, 128, 5, 113408),   # the largest served OvR bank
    (1, 6, 986, 64, 16, 84480)])       # one served row
def test_float32_decision_plan_is_unchanged_at_served_banks(
        nt, tasks, w, rows, splits, smem):
    """A float32 bank's plan at the served shapes (102 features) is the
    one the float32 kernel always took; a 16-bit bank's takes the same
    tile and split with 27,648 bytes less (two 64 x 108 stages)."""
    plan = D.decision_plan(nt, tasks, w, 102)
    assert (plan.rows, plan.splits, plan.chunk, plan.smem_bytes) == (
        rows, splits, 104, smem)
    for bank in (torch.float16, torch.bfloat16):
        half = D.decision_plan(nt, tasks, w, 102, bank=bank)
        assert half == plan._replace(smem_bytes=smem - 27648)
    with pytest.raises(ValueError, match="no decision kernel"):
        D.decision_plan(nt, tasks, w, 102, bank=torch.float64)


def test_decision_plans_cover_split_and_unsplit():
    """The shapes test_torch_cuda.py runs the decision kernel at take
    both tiles, split and unsplit grids and the chunked feature path."""
    plans = [D.decision_plan(*s) for s in [
        (8448, 1, 17, 102), (3277, 1, 300, 102), (1024, 6, 986, 102),
        (1, 9, 3792, 102), (65, 3, 700, 129), (200, 2, 257, 300),
        (37, 4, 70, 3)]]
    assert {p.rows for p in plans} == {64, 128}
    assert min(p.splits for p in plans) == 1
    assert max(p.splits for p in plans) > 1
    assert {p.chunk for p in plans} >= {64, 104}


@pytest.mark.parametrize("w", [1, 64, 65, 986, 3792, 4096, 4097, 29491,
                               100000])
def test_segments_depend_on_the_bank_width_alone(w):
    """The kernel adds a row's SV tiles within a segment, then the
    segments, in order, and splits take whole segments: the segments
    must not move with the rows, the tasks or the card, or a row's bits
    would depend on its batch. At most MAX_SEGMENTS of them, each as
    short as that allows (one tile up to 4,096 SVs)."""
    tiles = math.ceil(w / D.SV_TILE)
    plans = [D.decision_plan(nt, tasks, w, d, sms)
             for nt in (1, 37, 1024, 29491) for tasks in (1, 9)
             for d in (17, 300) for sms in (SMS, 16)]
    assert len({(p.seg, p.segments) for p in plans}) == 1
    seg, segments = plans[0].seg, plans[0].segments
    assert segments <= D.MAX_SEGMENTS
    assert seg * (segments - 1) < tiles <= seg * segments
    assert seg == 1 or math.ceil(tiles / (seg - 1)) > D.MAX_SEGMENTS
    if tiles > 1:   # both kinds of launch
        assert {p.splits for p in plans} != {1}


def test_plan_with_refuses_what_the_kernel_cannot_run():
    """A sweep's or a test's own plan: 64 or 128 rows, 1 to the bank's
    segments splits, the same layout as the chosen plan's."""
    assert D.plan_with(1024, 6, 986, 102, 128, 8) == D.decision_plan(
        1024, 6, 986, 102)
    for rows, splits in ((32, 1), (64, 0), (64, 17)):
        with pytest.raises(ValueError):
            D.plan_with(1024, 6, 986, 102, rows, splits)



@pytest.mark.parametrize("n,blocks", [
    (29491, 29),        # the binary fit: one float4 a thread of 256
    (7430, 8),          # an OvO task
    (33178, 33),        # an OvR task
    (1024, 1), (1025, 2), (1, 1),
    (10 ** 6, 128)])    # capped: threads then take several float4s
def test_kkt_select_blocks(n, blocks):
    """kkt_select's one launch: blocks a task by one float4 of the inputs
    a thread, at most MAX_BLOCKS."""
    from repro_torch.kernels import kkt_select as KS
    assert KS.n_blocks(n) == blocks


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_plan_shared_memory_fits_every_width(dtype):
    """Every d <= 128, both query tiles: the ring takes 3 stages where
    they fit, else 2, within the 232,448 bytes a block may take."""
    for d in range(1, 129):
        for rows in FA.ROWS:
            plan = FA.flash_plan(1, 300, 4, d, dtype, rows=rows)
            assert plan.smem_bytes <= MAX_SMEM
            assert plan.smem_bytes == FA.smem_bytes(
                rows, plan.stages, plan.d_tiles, 2 if dtype == torch.bfloat16
                else 4)
            assert plan.d_tiles * 8 >= d
            if plan.stages < max(FA.STAGES):
                assert FA.smem_bytes(rows, plan.stages + 1, plan.d_tiles,
                                     2 if dtype == torch.bfloat16
                                     else 4) > MAX_SMEM


@pytest.mark.parametrize("b,sq,h,rows", [
    (1, 4096, 24, 128),   # phi4_mini_3p8b: 24 x 32 = 768 blocks
    (2, 300, 24, 128),    # the ragged case: 48 x 3 = 144
    (1, 77, 3, 64),       # few blocks: 64-row tiles
    (1, 1, 2, 64)])
def test_flash_query_tiles_cover_the_queries(b, sq, h, rows):
    plan = FA.flash_plan(b, sq, h, 128, sms=SMS)
    assert plan.rows == rows
    tiles = plan.grid[1]
    assert plan.grid[0] == b * h
    assert (tiles - 1) * rows < sq <= tiles * rows
    covered = sorted(r for t in range(tiles)
                     for r in range(t * rows, min((t + 1) * rows, sq)))
    assert covered == list(range(sq))


@pytest.mark.parametrize("sq,sk", [(4096, 4096), (300, 300), (77, 300),
                                   (300, 77), (1, 130), (129, 64)])
@pytest.mark.parametrize("rows", FA.ROWS)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_key_tiles_equal_a_brute_force_count(sq, sk, rows, causal):
    """A block walks exactly the key tiles that hold a key some row of
    its query tile sees (causal: key <= row; every key below sk): they
    are a prefix of the tiles, as many as the kernel walks."""
    keys = torch.arange(sk)
    for qt in range(math.ceil(sq / rows)):
        q0 = qt * rows
        qrows = torch.arange(q0, min(q0 + rows, sq))
        seen = ((keys[None, :] <= qrows[:, None]) if causal
                else torch.ones((len(qrows), sk), dtype=torch.bool))
        need = sorted(set((keys[seen.any(0)] // FA.KEYS).tolist()))
        assert need == list(range(len(need)))
        assert FA.key_tiles(q0, rows, sq, sk, causal) == len(need)


@pytest.mark.parametrize("tiles", [1, 2, 3, 32, 64])
def test_flash_heaviest_tile_first_is_a_permutation(tiles):
    order = FA.tile_order(tiles)
    assert sorted(order) == list(range(tiles))
    walks = [FA.key_tiles(t * 128, 128, tiles * 128, tiles * 128, True)
             for t in order]
    assert walks == sorted(walks, reverse=True)


def test_ssd_plan_shared_memory_fits_every_state_width():
    for n in range(1, 257):
        plan = SD.ssd_plan(16, 48, 256, n, 64)
        assert plan.smem_bytes == SD.smem_bytes(n, plan.stages)
        assert plan.smem_bytes <= MAX_SMEM
        if plan.stages < max(SD.STAGES):
            assert SD.smem_bytes(n, plan.stages + 1) > MAX_SMEM


@pytest.mark.parametrize("bc,h,q,group,blocks", [
    (16, 48, 256, 12, 256),  # mamba2_780m: 16 chunks x 4 tiles x 4 groups
    (2, 6, 300, 2, 30),      # few blocks: the smallest group
    (1, 1, 64, 2, 1),
    (64, 48, 256, 48, 256)])   # many chunks: one group fills the card
def test_ssd_head_groups_cover_the_heads(bc, h, q, group, blocks):
    plan = SD.ssd_plan(bc, h, q, 128, 64, sms=SMS)
    assert plan.group == group and plan.group % 2 == 0
    assert plan.grid == (plan.q_tiles * plan.groups * bc,) == (blocks,)
    heads = sorted(gi * plan.group + j for gi in range(plan.groups)
                   for j in range(min(plan.group, h - gi * plan.group)))
    assert heads == list(range(h))
    assert (plan.q_tiles - 1) * SD.ROWS < q <= plan.q_tiles * SD.ROWS


def test_ssd_grid_order_is_a_permutation_heaviest_tile_first():
    """Block i runs (tile, group, chunk): every triple once, the tiles in
    falling order over the whole grid (longest first)."""
    bc = 16
    plan = SD.ssd_plan(bc, 48, 256, 128, 64)
    cells = [SD.block_of(plan, bc, i) for i in range(plan.grid[0])]
    assert sorted(cells) == sorted((t, g, c) for t in range(plan.q_tiles)
                                   for g in range(plan.groups)
                                   for c in range(bc))
    tiles = [t for t, _, _ in cells]
    assert tiles == sorted(tiles, reverse=True)


def test_ssd_cost_model_at_mamba2():
    """The head group's cost at mamba2_780m (stages of one block): the
    work over 132 SMs, or the longest block (tile 3, four chunks) once
    the grid is short; 12 heads a group is the least."""
    per = {g: 1 + g // 2 for g in (8, 12, 16, 24)}   # a chunk's stages
    for g, stages in per.items():
        total = 16 * math.ceil(48 / g) * stages * 10   # tiles walk 1..4
        assert SD.plan_cost(16, 48, 256, 128, 64, g) == pytest.approx(
            max(total / SMS, 4 * stages))
    best = min(range(2, 49, 2),
               key=lambda g: SD.plan_cost(16, 48, 256, 128, 64, g))
    assert best == SD.ssd_plan(16, 48, 256, 128, 64).group == 12


# --------------------------------------------------------------- backward
# flash_attn.bwd_plan and ssd_diag.bwd_plan (csrc/flash_attn_bwd.cu,
# csrc/ssd_diag_bwd.cu): shared memory, grids and walks as the kernels
# compute them, and the wrappers' refusals, with the launchers stubbed.
BWD_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("dtype,o_dtype", BWD_DTYPES)
def test_flash_bwd_plan_fits_every_width(dtype, o_dtype):
    """Every d <= 128 the wrapper accepts: both launches within the
    232,448 bytes a block may take."""
    for d in range(1, 129):
        plan = FA.bwd_plan(2, 300, 300, 8, 2, d, dtype, o_dtype)
        elem = 2 if plan.route == "bf16" else 4
        assert plan.route == ("bf16" if o_dtype == dtype == torch.bfloat16
                              else "tf32x3")
        assert plan.width >= d and plan.width in (32, 64, 128)
        assert plan.q_tile == (32 if plan.width == 128 else 64)
        assert plan.smem_kv == FA.bwd_smem_kv(plan.width, elem) <= MAX_SMEM
        assert plan.smem_q == FA.bwd_smem_q(plan.width, elem) <= MAX_SMEM


def test_flash_bwd_rows_are_conflict_free_strides():
    """A staged row is padded to 4 (mod 8) words, so ldmatrix's eight
    rows of 16 bytes start in eight different groups of four banks."""
    for width in (32, 64, 128):
        for elem in (2, 4):
            ls = FA.bwd_row_words(width, elem)
            assert ls % 8 == 4
            assert len({(r * ls) % 32 for r in range(8)}) == 8


@pytest.mark.parametrize("b,s,h,hkv", [(2, 2048, 32, 32), (1, 4096, 24, 8),
                                       (2, 300, 8, 2), (1, 1, 4, 1)])
@pytest.mark.parametrize("d", [36, 64, 128])
def test_flash_bwd_grids_cover_every_tile_once(b, s, h, hkv, d):
    """The dK / dV grid holds every (batch, kv head, key block) once (128
    keys a block on the TF32 route, 64 on bf16), the dQ grid every
    (batch, head, query tile of 64) once, the last first."""
    for dtype in (torch.bfloat16, torch.float32):
        plan = FA.bwd_plan(b, s, s, h, hkv, d, dtype)
        assert plan.kv_keys == (128 if dtype == torch.float32 else 64)
        assert plan.grid_kv == (b * hkv, math.ceil(s / plan.kv_keys))
        assert plan.grid_q == (b * h, math.ceil(s / FA.BWD_ROWS))
        firsts = [FA.bwd_q_walk(s, s, y, True)[0]
                  for y in range(plan.grid_q[1])]
        assert sorted(firsts) == [t * FA.BWD_ROWS
                                  for t in range(plan.grid_q[1])]
        assert firsts == sorted(firsts, reverse=True)


@pytest.mark.parametrize("sq,sk", [(4096, 4096), (300, 300), (77, 300),
                                   (300, 77), (1, 130), (129, 64)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_walks_equal_a_brute_force_count(sq, sk, d, causal, dtype):
    """The dK / dV block of a key tile walks exactly the query tiles
    (for each query head of its group) with a row that sees one of its
    keys, and the dQ block of a query tile exactly the key tiles one of
    its rows sees; the longest walks run first on both grids."""
    group = 3
    plan = FA.bwd_plan(1, sq, sk, 6, 2, d, dtype)
    qt = plan.q_tile
    rows, keys = torch.arange(sq), torch.arange(sk)
    sees = ((keys[None, :] <= rows[:, None]) if causal
            else torch.ones((sq, sk), dtype=torch.bool))
    kv_walks = []
    for kt in range(plan.grid_kv[1]):
        block = sees[:, kt * plan.kv_keys:(kt + 1) * plan.kv_keys].any(1)
        need = sorted(set((rows[block] // qt * qt).tolist()))
        walk = FA.bwd_kv_walk(plan, sq, kt, causal, group)
        assert walk == [(hh, q0) for hh in range(group) for q0 in need]
        kv_walks.append(len(walk))
    assert kv_walks == sorted(kv_walks, reverse=True)
    q_walks = []
    for y in range(plan.grid_q[1]):
        q0, n = FA.bwd_q_walk(sq, sk, y, causal)
        block = sees[q0:q0 + FA.BWD_ROWS].any(0)
        need = sorted(set((keys[block] // FA.BWD_KT).tolist()))
        assert need == list(range(n))
        q_walks.append(n)
    assert q_walks == sorted(q_walks, reverse=True)


@pytest.mark.parametrize("q", [20, 64, 100, 200, 256, 1000, 4096])
@pytest.mark.parametrize("p", [1, 5, 40, 64, 65, 72, 128])
def test_ssd_bwd_plan_fits_every_state_size(q, p):
    """Every P <= 128 and N <= 256 the wrapper accepts, at chunk lengths
    up to 4,096: the walk and the dC / dB launch fit in shared memory; a
    forced head group that does not fit is refused."""
    for bc, h in ((16, 64), (2, 3), (1, 48)):
        plan = SD.bwd_plan(bc, h, q, 64, p)
        assert plan.smem_bytes == SD.bwd_smem_bytes(q, p,
                                                    plan.group) <= MAX_SMEM
        assert plan.tiles == math.ceil(q / SD.BWD_TILE)
        assert plan.pairs == plan.tiles * (plan.tiles + 1) // 2
    for n in range(1, 257):
        assert SD.bwd_dcdb_smem_bytes(n) <= MAX_SMEM
    if SD.bwd_smem_bytes(q, p, 64) <= MAX_SMEM:
        assert SD.bwd_plan(16, 64, q, 64, p, group=64).group == 64
    else:
        with pytest.raises(ValueError):
            SD.bwd_plan(16, 64, q, 64, p, group=64)


@pytest.mark.parametrize("bc,h,q,n,p,group", [
    (16, 64, 256, 64, 64, 8),    # zamba2_1p2b: 128 blocks, one wave
    (16, 48, 256, 128, 64, 6),   # mamba2_780m: 8 groups
    (4, 64, 256, 64, 64, 2),     # few chunks: smaller groups fill the card
    (3, 2, 20, 8, 5, 1),
    (2, 5, 200, 18, 40, 1)])
def test_ssd_bwd_head_groups_cover_the_heads(bc, h, q, n, p, group):
    """The head group of least cost; blocks (chunk, group) each once, the
    full groups of every chunk first; the groups cover the heads once."""
    plan = SD.bwd_plan(bc, h, q, n, p, sms=SMS)
    assert plan.group == group
    assert plan.groups == math.ceil(h / group)
    assert plan.grid == (bc * plan.groups,)
    assert plan.grid_dcdb == (bc * plan.tiles * 2,)
    cells = [SD.bwd_block_of(bc, i) for i in range(plan.grid[0])]
    assert sorted(cells) == [(c, g) for c in range(bc)
                             for g in range(plan.groups)]
    sizes = [min(group, h - g * group) for _, g in cells]
    assert sizes == sorted(sizes, reverse=True)
    heads = sorted(g * group + j for g in range(plan.groups)
                   for j in range(min(group, h - g * group)))
    assert heads == list(range(h))
    best = min(range(1, h + 1),
               key=lambda g: (SD.bwd_cost(bc, h, q, n, p, g, SMS)
                              if SD.bwd_smem_bytes(q, p, g) <= MAX_SMEM
                              else math.inf, math.ceil(h / g), g))
    assert best == group


@pytest.mark.parametrize("tiles", [1, 2, 4, 16])
def test_ssd_bwd_pairs_follow_the_walk(tiles):
    """The walk's pairs (i >= j, key tile j outer) and the kernel's pair
    index j T - j (j - 1) / 2 + i - j agree, every lower-triangle pair
    once."""
    pairs = SD.bwd_pairs(tiles)
    assert sorted(pairs) == sorted((i, j) for i in range(tiles)
                                   for j in range(i + 1))
    for idx, (i, j) in enumerate(pairs):
        assert idx == j * tiles - j * (j - 1) // 2 + (i - j)


class _BwdLaunches:
    """The backward wrappers' launchers replaced by recorders: the
    wrappers take their card path on CPU tensors and hand their plan
    here instead of launching."""

    def __init__(self, monkeypatch):
        from repro_torch.kernels import ops
        self.ops, self.plans = ops, []
        monkeypatch.setattr(ops, "_on_card", lambda *a: True)
        monkeypatch.setattr(ops, "_sm_count", lambda dev: SMS)
        monkeypatch.setattr(ops._build, "library", lambda: None)

        def plan_of(*a, plan, **kw):
            self.plans.append(plan)
            return 0
        monkeypatch.setattr(FA, "launch_bwd", plan_of)
        monkeypatch.setattr(SD, "launch_bwd", plan_of)
        ops.reset_launches()

    def refused(self, fn, *args, **kw):
        with pytest.raises(ValueError):
            fn(*args, **kw)
        return not self.plans and not any(self.ops.launches.values())


def _attn(b=2, s=40, h=4, hkv=2, d=16, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((b, s, h, d), generator=g).to(dtype)
    k, v = (torch.randn((b, s, hkv, d), generator=g).to(dtype)
            for _ in range(2))
    o = torch.randn((b, s, h, d), generator=g).to(dtype)
    return q, k, v, o, torch.zeros((b, h, s)), torch.randn_like(o)


def test_flash_bwd_wrapper_refuses_what_the_kernel_cannot_run(monkeypatch):
    rec = _BwdLaunches(monkeypatch)
    fn = rec.ops.flash_attention_bwd
    q, k, v, o, lse, do = _attn()
    fn(q, k, v, o, lse, do)
    assert rec.plans == [FA.bwd_plan(2, 40, 40, 4, 2, 16, torch.float32,
                                     torch.float32)]
    assert rec.ops.launches["flash_attention_bwd"] == 1
    rec.plans.clear()
    rec.ops.reset_launches()
    wide = _attn(d=136)
    assert rec.refused(fn, *wide)                              # D > 128
    assert rec.refused(fn, q, k[:, :, :1].expand(-1, -1, 3, -1).contiguous(),
                       v[:, :, :1].expand(-1, -1, 3, -1).contiguous(),
                       o, lse, do)                             # H % Hkv
    assert rec.refused(fn, q.double(), k.double(), v.double(), o.double(),
                       lse, do)                                # float64
    assert rec.refused(fn, q, k.bfloat16(), v, o, lse, do)     # mixed
    assert rec.refused(fn, q, k, v[:, :20], o, lse, do)        # v's shape
    assert rec.refused(fn, q, k, v, o, lse.double(), do)       # lse dtype
    assert rec.refused(fn, q.transpose(1, 2).contiguous().transpose(1, 2),
                       k, v, o, lse, do)                       # strides
    qb, kb, vb, ob, _, dob = _attn(dtype=torch.bfloat16)
    fn(qb, kb, vb, ob.float(), lse, dob)                       # f32 o: TF32
    assert rec.plans[-1].route == "tf32x3"


def test_ssd_bwd_wrapper_refuses_what_the_kernel_cannot_run(monkeypatch):
    rec = _BwdLaunches(monkeypatch)
    fn = rec.ops.ssd_diag_bwd
    g = torch.Generator().manual_seed(0)

    def operands(bc=2, h=3, q=100, n=16, p=8):
        return [torch.randn(sh, generator=g) for sh in
                ((bc, q, n), (bc, q, n), (bc, h, q, p), (bc, h, q),
                 (bc, h, q), (bc, h, q, p))]
    ops_ = operands()
    fn(*ops_)
    assert rec.plans == [SD.bwd_plan(2, 3, 100, 16, 8, sms=SMS)]
    assert rec.ops.launches["ssd_diag_bwd"] == 1
    rec.plans.clear()
    rec.ops.reset_launches()
    assert rec.refused(fn, *operands(n=257))                   # N > 256
    assert rec.refused(fn, *operands(p=129))                   # P > 128
    assert rec.refused(fn, *operands(q=1 << 16))               # no group fits
    c, b, x, dt, cs, dy = operands()
    assert rec.refused(fn, c.double(), b, x, dt, cs, dy)       # float64
    assert rec.refused(fn, c, b[:, :50], x, dt, cs, dy)        # B's shape
    assert rec.refused(fn, c, b, x, dt[:, :2], cs, dy)         # dt's shape
    assert rec.refused(fn, c.transpose(1, 2).contiguous().transpose(1, 2),
                       b, x, dt, cs, dy)                       # strides
