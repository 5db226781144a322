"""What the redesigned layered LDPC kernel (sdr_receiver_dvb_t2_tpu_torch/
csrc/ldpc_layered.cu) gets from Python, checked on the CPU:

- the packed table (`pack_tables`) against `qc_tables` for all 13 codes and
  three layer orders: every word decodes back to the layer, degree, group,
  shift and phase it stands for;
- the size rules: tables and info totals within one CTA's 232,448 bytes of
  shared memory for every code (`smem_bytes`, `check_fits`), the size of a
  check's stored row (`row_bytes`) and which kernel a code takes
  (`uniform_degree`);
- an emulation in PyTorch of the kernel's reordered dataflow, driven only by
  the packed table: the first sweep without old messages, the two minima
  by the kernel's fmin/fmax scan, a row's messages stored as two
  magnitudes, sign bits and one index, the parity totals carried from layer
  to layer or loaded a layer ahead as the table says, write-backs by phase.
  It is held to the plain versions (`layered_sweep`, `layered_sweep_hbm`) at
  tolerance 0 on the totals and the stored messages;
- the constants the packer shares with the kernel source, read out of the
  source's text, and the list of cases the card check runs per code.

The emulation is Python written beside the kernel, not the kernel: nothing
here compiles or runs the .cu.  Only the runs on the card hold it to the
plain versions (`chip_smoke.py`, and the `cuda`-marked tests)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu_torch.dvbt2.ldpc import _TABLE_KEY
from sdr_receiver_dvb_t2_tpu_torch.dvbt2.params import CodeRate, FECFrame
from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc_layered as tl
from sdr_receiver_dvb_t2_tpu_torch.ops.ldpc_tables import BIG, _layer_order
from sdr_receiver_dvb_t2_tpu_torch.tools import ldpc_layer_bench as lb

torch.set_num_threads(1)

S, N = FECFrame.SHORT, FECFrame.NORMAL
NU = 360
CODES = sorted(_TABLE_KEY, key=lambda c: (c[0].name, c[1].name))
SMEM_PER_CTA = 232448          # sm_90: the most one CTA may use


def _order(tab, name):
    if name == "permuted":
        return lb.permuted_order(tab.q)
    return _layer_order(tab.q, None if name == "natural" else name)


def _unpack(tab, words):
    """The packed table -> [(t, deg, phases, src_self, src_prev,
    [(g, s, phase), ...]), ...] in visiting order."""
    rows = np.asarray(words).view(np.uint32).astype(np.int64).reshape(
        tab.q, tl.TABLE_HDR + 2 * tab.degmax)
    steps = []
    for r in rows.tolist():
        deg, phases = r[1] & 255, (r[1] >> 8) & 255
        phase_bits = r[3] | (r[1] >> 16) << 32
        edges = []
        for j in range(deg):
            base, s = r[tl.TABLE_HDR + 2 * j], r[tl.TABLE_HDR + 2 * j + 1]
            base -= (base >> 31) << 32          # back to a signed word
            assert 0 <= s < NU and (base + 4 * s) % (4 * NU) == 0
            edges.append(((base + 4 * s) // (4 * NU), s,
                          (phase_bits >> 2 * j) & 3))
        assert phase_bits >> 2 * deg == 0
        assert not any(r[tl.TABLE_HDR + 2 * deg:])
        steps.append((r[0], deg, phases, r[2] & 15, r[2] >> 4, edges))
    return steps


@pytest.mark.parametrize("order_name", ["natural", "reversed", "permuted"])
@pytest.mark.parametrize("frame,rate", CODES, ids=str)
def test_packed_table_equals_qc_tables(frame, rate, order_name):
    tab = tl.qc_tables(frame, rate)
    order = _order(tab, order_name)
    words = tl.pack_tables(tab, order)
    assert words.dtype == np.int32
    assert words.shape == (tab.q * (tl.TABLE_HDR + 2 * tab.degmax),)
    steps = _unpack(tab, words)
    assert [s[0] for s in steps] == order
    for li, (t, deg, phases, s_self, s_prev, edges) in enumerate(steps):
        assert deg == tab.layer_deg[t]
        assert [e[0] for e in edges] == tab.entry_g[t, :deg].tolist()
        assert [e[1] for e in edges] == tab.entry_s[t, :deg].tolist()
        # phase = how many earlier edges of the layer hit the same group
        groups = [e[0] for e in edges]
        assert [e[2] for e in edges] == [groups[:j].count(g)
                                         for j, g in enumerate(groups)]
        assert phases == 1 + max(e[2] for e in edges)
        # within one phase every group is distinct: its write-backs touch
        # distinct addresses and need no order
        for ph in range(phases):
            gs = [e[0] for e in edges if e[2] == ph]
            assert len(gs) == len(set(gs))
        assert (s_self, s_prev) == tl._parity_sources(tab.q, t,
                                                      order[li - 1])
        # the offset rule of the kernel: check row u reads the roll by s
        base = words.reshape(tab.q, -1)[li, tl.TABLE_HDR::2][:deg]
        assert phases <= 4
        for (g, sh, _), b0 in zip(edges, base.tolist()):
            u = np.arange(NU)
            got = b0 + 4 * u + np.where(u < sh, 4 * NU, 0)   # bytes
            assert (got == 4 * (g * NU + (u - sh) % NU)).all()


def test_parity_sources_of_the_production_orders():
    q = 60
    # natural: the prev total is the self total this thread just wrote; the
    # self total is fresh, so it is loaded a layer ahead
    assert tl._parity_sources(q, 5, 4) == (tl.SRC_EARLY, tl.SRC_CARRY_SELF)
    # ... except across the sweep boundary: layer 0 reads row q-1 one
    # column to the left, which layer q-1 has just written
    assert tl._parity_sources(q, 0, q - 1) == (tl.SRC_EARLY, tl.SRC_LATE)
    # reversed: the self total is the prev total this thread just wrote
    assert tl._parity_sources(q, 4, 5) == (tl.SRC_CARRY_PREV, tl.SRC_EARLY)
    # ... except after layer 0, which wrote row q-1 across threads
    assert tl._parity_sources(q, q - 1, 0) == (tl.SRC_LATE, tl.SRC_EARLY)
    # unrelated neighbours: both a layer ahead
    assert tl._parity_sources(q, 10, 20) == (tl.SRC_EARLY, tl.SRC_EARLY)
    assert tl._parity_sources(q, 0, 7) == (tl.SRC_EARLY, tl.SRC_EARLY)


def test_permuted_order_is_a_non_monotone_permutation():
    for q in (8, 25, 30):
        order = lb.permuted_order(q)
        assert sorted(order) == list(range(q))
        steps = np.diff(order)
        assert (steps > 0).any() and (steps < 0).any()


@pytest.mark.parametrize("frame,rate", CODES, ids=str)
def test_shared_memory_and_row_size_rule(frame, rate):
    """Tables and info totals of every code fit one CTA (the messages stay
    in device memory and registers); a check's message row is whole
    16-byte chunks; which kernel a code takes."""
    tab = tl.qc_tables(frame, rate)
    used = tl.smem_bytes(tab)
    assert used <= tl.SMEM_BYTES < SMEM_PER_CTA
    assert used % 16 == 0
    assert used >= 4 * tab.n_groups * NU + 4 * tab.q * (
        tl.TABLE_HDR + 2 * tab.degmax)
    tl.check_fits(tab)
    degs = set(tab.layer_deg.tolist())
    udeg = tl.uniform_degree(tab)
    assert udeg == (degs.pop() if len(degs) == 1 else 0)
    assert bool(udeg) == (frame == N or rate in (CodeRate.C2_3,
                                                 CodeRate.C3_5))
    # a stored row: two magnitudes, one sign bit per edge below bit 24,
    # the index above it
    assert tab.degmax + 2 <= tl.MAX_EDGES == 24
    assert tl.row_bytes(torch.bfloat16) == 2 * 2 + 4
    assert tl.row_bytes(torch.float32) == 16 >= 2 * 4 + 4
    want = {(N, CodeRate.C2_3): 8, (N, CodeRate.C5_6): 20,
            (N, CodeRate.C3_5): 9, (S, CodeRate.C1_2): 0}
    if (frame, rate) in want:
        assert udeg == want[(frame, rate)]


def test_size_rule_raises_when_the_totals_do_not_fit():
    tab = tl.qc_tables(N, CodeRate.C5_6)      # the largest: 150 groups
    assert tl.smem_bytes(tab) == 4 * 150 * NU + 4 * 30 * (4 + 2 * 20)
    tl.check_fits(tab, limit=tl.smem_bytes(tab))
    with pytest.raises(ValueError):
        tl.check_fits(tab, limit=tl.smem_bytes(tab) - 1)


# --------------------------------------------------------------------------
# The kernel's dataflow, emulated from the packed table alone
# --------------------------------------------------------------------------

def _two_min(mags):
    """(min1, min2) of the magnitudes as the kernel's scan without argmin
    forms them: min2 = fmin(min2, fmax(min1, a)), then min1 = fmin(min1,
    a)."""
    min1, min2 = mags[0], torch.full_like(mags[0], BIG)
    for a in mags[1:]:
        min2 = torch.minimum(min2, torch.maximum(min1, a))
        min1 = torch.minimum(min1, a)
    return min1, min2


def _two_min_strict(mags):
    """The same by the plain versions' strict-< scan."""
    min1, min2 = mags[0], torch.full_like(mags[0], BIG)
    for a in mags[1:]:
        is_new = a < min1
        min2 = torch.where(is_new, min1, torch.minimum(min2, a))
        min1 = torch.where(is_new, a, min1)
    return min1, min2


def _bits(x):
    return x.contiguous().view(torch.int32)


def _through_stored_row(new, msgs, mags, min1, mag1, mag2, sign_all, amin,
                        c2v_dtype):
    """The row as the kernel stores it: the two magnitudes rounded to the
    storage type, a sign bit per edge, and the index of one edge that
    takes the second magnitude (K4: its argmin; else the first edge with
    |m| == min1, as the kernel's descending loop leaves it).  -> the messages rebuilt from that, which must equal
    `new`, the plain version's messages, bit for bit."""
    if amin is None:
        amin = torch.zeros(min1.shape, dtype=torch.int64)
        for j in reversed(range(len(mags))):
            amin = torch.where(mags[j] <= min1, j, amin)
    m1 = _bits(tl._stored(mag1, c2v_dtype))
    m2 = _bits(tl._stored(mag2, c2v_dtype))
    odd = sign_all < 0
    rebuilt = []
    for j, m in enumerate(msgs):
        sign = ((m < 0) != odd).int() << 31
        rebuilt.append((torch.where(amin == j, m2, m1) | sign
                        ).view(torch.float32))
    for a, b in zip(rebuilt, new):
        assert torch.equal(_bits(a), _bits(b))
    return rebuilt


def _emulate(tab, words, v, n_sweeps, c2v_dtype=torch.bfloat16,
             argmin=False):
    """`n_sweeps` sweeps as the kernel runs them -> (ti (G, 360, B),
    tp (q, 360, B), c2v {t: (deg + 2, 360, B)})."""
    q = tab.q
    steps = _unpack(tab, words)
    ti, tp = tl._stage_nb(tab, v)
    ti = ti[:tab.n_groups].clone()
    c2v = {}
    mask0 = torch.zeros((NU, 1))
    mask0[0] = BIG

    def prev_row(t):
        return tp[t - 1].clone() if t > 0 else torch.roll(tp[q - 1], 1, 0)

    c_self = c_prev = pre_self = pre_prev = None
    total = n_sweeps * q
    for gs in range(total):
        t, deg, phases, s_self, s_prev, edges = steps[gs % q]
        first = gs < q
        if gs == 0:
            s_self = s_prev = tl.SRC_LATE
        self_p = {tl.SRC_EARLY: pre_self, tl.SRC_CARRY_SELF: c_self,
                  tl.SRC_CARRY_PREV: c_prev}.get(s_self)
        if s_self == tl.SRC_LATE:
            self_p = tp[t].clone()
        prev_p = {tl.SRC_EARLY: pre_prev, tl.SRC_CARRY_SELF: c_self,
                  tl.SRC_CARRY_PREV: c_prev}.get(s_prev)
        if s_prev == tl.SRC_LATE:
            prev_p = prev_row(t)
        # the next layer's totals, read before this layer writes anything
        if gs + 1 < total:
            nt, _, _, n_self, n_prev, _ = steps[(gs + 1) % q]
            pre_self = tp[nt].clone() if n_self == tl.SRC_EARLY else None
            pre_prev = prev_row(nt) if n_prev == tl.SRC_EARLY else None
        gathered = [torch.roll(ti[g], s, 0) for g, s, _ in edges]
        gathered += [self_p, prev_p]
        if first:                       # no stored messages: x - 0.0 is x
            msgs = gathered
        else:
            msgs = [x - c2v[t][j] for j, x in enumerate(gathered)]
        if t == 0:
            msgs[deg + 1] = msgs[deg + 1] + mask0
        mags = [m.abs() for m in msgs]
        nneg = sum((m < 0).int() for m in msgs)
        sign_all = (1 - 2 * (nneg % 2)).float()
        if argmin:
            min1, min2 = mags[0], torch.full_like(mags[0], BIG)
            amin = torch.zeros(min1.shape, dtype=torch.int64)
            for j in range(1, deg + 2):
                is_new = mags[j] < min1
                min2 = torch.where(is_new, min1,
                                   torch.minimum(min2, mags[j]))
                min1 = torch.where(is_new, mags[j], min1)
                amin = torch.where(is_new, j, amin)
        else:
            min1, min2 = _two_min(mags)
        mag1 = torch.clamp(min1 - tl.OFFSET, min=0.0)
        mag2 = torch.clamp(min2 - tl.OFFSET, min=0.0)
        new = []
        for j, (m, a) in enumerate(zip(msgs, mags)):
            loo = torch.where(amin == j if argmin else a <= min1, mag2, mag1)
            sgn = torch.where(m < 0, -sign_all, sign_all)
            new.append(tl._stored(sgn * loo, c2v_dtype))
        new = _through_stored_row(new, msgs, mags, min1, mag1, mag2, sign_all,
                                  amin if argmin else None, c2v_dtype)
        delta = new if first else [n - c2v[t][j] for j, n in enumerate(new)]
        c_self = msgs[deg] + new[deg]
        c_prev = msgs[deg + 1] + new[deg + 1]
        tp[t] = c_self
        if t > 0:
            tp[t - 1] = c_prev
        else:
            tp[q - 1, :NU - 1] = (c_prev - 0.0)[1:]
        for ph in range(phases):
            for j, (g, s, p) in enumerate(edges):
                if p == ph:
                    ti[g] += torch.roll(delta[j], -s, 0)
        c2v[t] = torch.stack(new)
    return ti, tp, c2v


def _llrs(frame, rate, b, seed):
    from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen
    cw = benchgen.codewords(frame, rate, b, seed=seed)
    return lb.channel_llrs(cw, lb.sigma_for(rate),
                           np.random.default_rng(seed), torch.float32, "cpu")


@pytest.mark.parametrize("order_name", ["natural", "reversed", "permuted"])
@pytest.mark.parametrize("rate", [CodeRate.C1_2, CodeRate.C3_5], ids=str)
def test_emulated_dataflow_equals_layered_sweep(rate, order_name):
    tab = tl.qc_tables(S, rate)
    order = _order(tab, order_name)
    v = _llrs(S, rate, 4, seed=7)
    n_sweeps = 3
    ti, tp, c2v = _emulate(tab, tl.pack_tables(tab, order), v, n_sweeps)
    rti, rtp = tl._stage_nb(tab, v)
    rc2v = torch.zeros((tab.q, tab.degmax + 2) + rtp.shape[1:])
    for _ in range(n_sweeps):
        tl.layered_sweep(tab, order, rti, rtp, rc2v)
    assert torch.equal(ti, rti[:tab.n_groups])
    assert torch.equal(tp, rtp)
    for t in range(tab.q):
        assert torch.equal(c2v[t], rc2v[t, :int(tab.layer_deg[t]) + 2])
    # the input is a discriminating one: not every bit has settled
    assert (rti[:tab.n_groups] < 0).any() and (rti[:tab.n_groups] > 0).any()


@pytest.mark.parametrize("rate", [CodeRate.C1_2, CodeRate.C3_5], ids=str)
def test_emulated_dataflow_equals_layered_sweep_hbm(rate):
    """K4's mode: f32 messages, the leave-one-out minimum at the argmin of
    the scan over the real edges (its +BIG slots change neither minimum)."""
    tab = tl.qc_tables(S, rate)
    order = list(range(tab.q))
    v = _llrs(S, rate, 4, seed=9)
    ti, tp, _ = _emulate(tab, tl.pack_tables(tab, order), v, 3,
                         c2v_dtype=torch.float32, argmin=True)
    rti, rtp = tl._stage_nb(tab, v)
    rc2v = torch.zeros((tab.q, tab.degmax + 2) + rtp.shape[1:])
    for _ in range(3):
        tl.layered_sweep_hbm(tab, rti, rtp, rc2v)
    assert torch.equal(ti, rti[:tab.n_groups])
    assert torch.equal(tp, rtp)


@pytest.mark.parametrize("vals", [
    [3.0, 1.0, 1.0, 2.0], [1.0, 5.0, 4.0, 1.0], [2.0, 2.0, 2.0],
    [7.0, 3.0, 9.0, 1.0, 4.0], [0.0, 0.0, 5.0], [4.0, 3.0, 2.0, 1.0],
    [1.0, 2.0, 3.0, 4.0], [BIG, 2.0, BIG]], ids=str)
def test_fmin_fmax_scan_gives_the_two_minima(vals):
    """The kernel's scan without argmin gives the minimum and the second
    smallest counted with multiplicity (a minimum attained twice makes
    min2 == min1), the same two values as the plain versions' strict-<
    scan, whatever the order of the edges."""
    mags = [torch.tensor([x]) for x in vals]
    want = sorted(vals)[:2]
    for scan in (_two_min, _two_min_strict):
        min1, min2 = scan(mags)
        assert [float(min1), float(min2)] == want
    rng = np.random.default_rng(len(vals))
    many = [torch.from_numpy(rng.integers(0, 4, 512).astype(np.float32))
            for _ in vals]
    for a, b in zip(_two_min(many), _two_min_strict(many)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("frame,rate", CODES, ids=str)
def test_card_check_cases_of_every_code(frame, rate):
    """The list of cases the card check runs for a code (no decode here):
    both fixed doors, the adaptive exit in reversed order, the permuted
    order and the large batch where they belong, at a noise level a few
    tenths of a dB above the code's threshold."""
    got = lb.cases(frame, rate)
    q = tl.qc_tables(frame, rate).q
    labels = [c[0] for c in got]
    assert len(set(labels)) == len(labels)
    assert [c[1:] for c in got[:3]] == [
        ("vmem", None, lb.CHECK_BATCH), ("hbm", None, lb.CHECK_BATCH),
        ("adaptive", "reversed", lb.CHECK_BATCH)]
    permuted = [c for c in got if isinstance(c[2], list)]
    assert bool(permuted) == ((frame, rate) in (
        (S, CodeRate.C1_2), (N, CodeRate.C5_6)))
    for _, door, order, batch in permuted:
        assert door == "adaptive" and batch == lb.CHECK_BATCH
        assert sorted(order) == list(range(q))
        # neither of the orders the other cases run
        assert order not in (_layer_order(q, None),
                             _layer_order(q, "reversed"))
    large = [c for c in got if c[3] != lb.CHECK_BATCH]
    assert bool(large) == ((frame, rate) in lb.LARGE)
    # more codewords than the card has SMs, so a launch per chunk
    assert all(c[3] > 132 and c[1] == "adaptive" for c in large)
    assert lb.CHECK_BATCH == 8
    assert (frame, rate) in lb.all_codes() and len(lb.all_codes()) == 13
    snr_db = -20.0 * np.log10(lb.sigma_for(rate))
    assert snr_db == pytest.approx(lb.THRESHOLD_DB[rate.name] + 0.9)


def test_channel_llrs_layout_and_the_clean_channel():
    cw = np.array([[0, 1, 1], [1, 0, 0]])
    clean = lb.channel_llrs(cw, 0.0, None, torch.float32, "cpu")
    assert clean.shape == (3, 2)
    assert torch.equal(clean, torch.tensor(8.0 * (1 - 2 * cw.T),
                                           dtype=torch.float32))
    noisy = lb.channel_llrs(cw, 0.5, np.random.default_rng(0),
                            torch.bfloat16, "cpu")
    assert noisy.dtype == torch.bfloat16 and noisy.shape == (3, 2)
    assert not torch.equal(noisy.float(), clean)


# --------------------------------------------------------------------------
# The constants the packer shares with the kernel source
# --------------------------------------------------------------------------

CU = (Path(tl.__file__).resolve().parent.parent / "csrc"
      / "ldpc_layered.cu").read_text()


def _cu_const(name):
    found = re.findall(rf"constexpr int {name} = (\d+);", CU)
    assert len(found) == 1, name
    return int(found[0])


def _cu_list(macro):
    body = re.search(rf"#define {macro}\(X\)((?:\s*\\?\s*X\(\d+\))+)", CU)
    return [int(d) for d in re.findall(r"X\((\d+)\)", body.group(1))]


@pytest.mark.parametrize("cu_name,py_value", [
    ("HDR", tl.TABLE_HDR), ("SRC_EARLY", tl.SRC_EARLY),
    ("SRC_CARRY_SELF", tl.SRC_CARRY_SELF),
    ("SRC_CARRY_PREV", tl.SRC_CARRY_PREV), ("SRC_LATE", tl.SRC_LATE),
    ("MAX_EDGES", tl.MAX_EDGES), ("PHASE_LO_EDGES", tl.PHASE_LO_EDGES),
    ("NU", NU), ("SMEM_LIMIT", SMEM_PER_CTA), ("THREADS", tl.THREADS),
    ("SMEM_STATIC", tl.SMEM_STATIC)])
def test_kernel_source_has_the_packers_constants(cu_name, py_value):
    assert _cu_const(cu_name) == py_value


def test_kernel_source_layout_export_and_shared_memory_reserve():
    # the order in which the library reports its layout is TABLE_LAYOUT's
    listed = re.search(r"const int layout\[\] = \{([^}]*)\}", CU).group(1)
    names = [w.strip() for w in listed.split(",")]
    assert tuple(_cu_const(n) for n in names) == tl.TABLE_LAYOUT
    assert tl.SMEM_BYTES == _cu_const("SMEM_LIMIT") - _cu_const("SMEM_STATIC")


def test_kernel_source_is_compiled_for_every_codes_degrees():
    uniform, mixed = set(), set()
    for frame, rate in CODES:
        tab = tl.qc_tables(frame, rate)
        if tl.uniform_degree(tab):
            uniform.add(tl.uniform_degree(tab))
        else:
            mixed |= set(tab.layer_deg.tolist())
    assert set(_cu_list("LDPC_UNIFORM")) == uniform
    assert set(_cu_list("LDPC_DEGREES")) == mixed


def test_build_variant_changes_the_cache_key_and_restores_it():
    """The profiling build (`-DLDPC_PROFILE`) is a library of its own in
    the build cache; outside the block the regular one is back."""
    from sdr_receiver_dvb_t2_tpu_torch import _build
    regular = _build._paths("ldpc_layered")[1]
    with _build.variant("ldpc_layered", "-DLDPC_PROFILE"):
        assert _build._paths("ldpc_layered")[1] != regular
        assert _build._paths("fft_stage1")[1].name.startswith("fft_stage1-")
        assert "-DLDPC_PROFILE" in _build._flags("ldpc_layered")
        assert "-DLDPC_PROFILE" not in _build._flags("fft_stage1")
    assert _build._paths("ldpc_layered")[1] == regular
    assert "--fmad=false" in _build._flags("ldpc_layered")


def test_ptxas_report_is_grouped_by_kernel():
    """The tool's build report: the compiler's lines grouped under the
    function they belong to (demangled where the machine has c++filt)."""
    sym = ("_ZN48_GLOBAL__N__148de840_15_ldpc_layered_cu_fce102e611sweep_chunk"
           "IfLb1ELi20EEEvPfS1_PNS_3RowIT_EEPiPKiNS_4DimsEiiS8_iiif")
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{sym}' for 'sm_90a'",
        f"ptxas info    : Function properties for {sym}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 122 registers, used 1 barriers, 64 bytes smem",
        "ptxas info    : Function properties for _Z9stage_outPKfS0_Ph4Dimsiii",
        "    0 bytes stack frame, 4 bytes spill stores, 0 bytes spill loads"])
    rows = lb.ptxas_by_kernel(log)
    assert len(rows) == 2
    assert "sweep_chunk" in rows[0] and "Used 122 registers" in rows[0]
    assert "0 bytes spill stores" in rows[0]
    assert "stage_out" in rows[1] and "4 bytes spill stores" in rows[1]
    assert lb.ptxas_by_kernel("") == []
