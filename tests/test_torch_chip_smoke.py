"""chip_smoke.py's tables and parsers that the CPU can check (the script
itself runs on the card): the zoo's dense configs and mixtral-8x22b at
their depths, the train phase's dense and mixtral cells at theirs, the SASS
listing that phase 6 counts
threefry's integer instructions from, the phase selection, the probe
phase's shapes, launches, TopLEK plan and bounds, and the CPU worker that
computes the card-versus-CPU checks' CPU sides.
"""

import dataclasses
import importlib.util
import re
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import init_lm_params
from repro_torch.models import lm as tlm
from repro_torch.models.lm import cast_for_compute
from repro_torch.train import adamw_init, make_prefill_step, make_train_step, synthetic_batch
from repro_torch.train.optimizer import tree_map

DENSE_ZOO = ["chatglm3-6b", "nemotron-4-15b", "yi-34b"]
CUT_ZOO = DENSE_ZOO + ["mixtral-8x22b"]  # the configs the card runs at depth cuts


def _train_layers(cs) -> dict:
    """arch -> its train cell's full-width depth, for CUT_ZOO."""
    return {**cs.DENSE_TRAIN_LAYERS, "mixtral-8x22b": cs.MIXTRAL_TRAIN_LAYERS}


def _chip_smoke():
    """chip_smoke.py, loaded by its path (the repo's root is no package)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bytes(tree: dict) -> int:
    return sum(_bytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
               for v in tree.values())


@pytest.mark.parametrize("arch", CUT_ZOO)
def test_zoo_flash_launches_are_the_prefills_attention_calls(arch, monkeypatch):
    """The zoo's 32k prefill (b) launches flash once per chunked_attention
    call: at the depth ZOO_DEPTHS gives, on a reduced width, the calls
    equal ZOO_FLASH_ROUTES' wgmma count (head_dim 128: the wgmma route),
    each with the config's window (none but mixtral-8x22b's)."""
    cs = _chip_smoke()
    depth, _ = cs.ZOO_DEPTHS[arch]
    assert get_config(arch).head_dim == 128
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=depth)
    calls = []
    plain = tlm.chunked_attention

    def counted(*args, **kwargs):
        calls.append(kwargs.get("window"))
        return plain(*args, **kwargs)

    monkeypatch.setattr(tlm, "chunked_attention", counted)
    params = init_lm_params(0, cfg, "cpu")
    tokens = torch.as_tensor(torch.arange(8).reshape(1, 8) % cfg.vocab)
    logits = make_prefill_step(cfg)(params, {"tokens": tokens})
    assert logits.shape == (1, tlm.padded_vocab(cfg))
    assert cs.ZOO_FLASH_ROUTES[arch] == {"wgmma": len(calls), "simt": 0}
    assert calls == [cfg.window] * depth  # causal, and the config's window
    assert (cfg.window is None) == (arch in DENSE_ZOO)


@pytest.mark.parametrize("arch", CUT_ZOO)
def test_zoo_depths_are_the_deepest_that_fit_the_budget(arch):
    """Counted on meta: the f32 params at the prefill depth, and the f32
    params with ServeEngine's bf16 copy at the engine depth, fit the
    config's budget (ZOO_PARAM_BYTES_MAX; mixtral-8x22b's: 80 GB less its
    measured prefill's peak above its params), and one layer more (where
    there is one) would not; chip_smoke.zoo_param_bytes counts the same
    bytes; the roofline phase counts a cut prefill at the zoo's depth."""
    cs = _chip_smoke()
    full = get_config(arch)
    prefill_layers, engine_layers = cs.ZOO_DEPTHS[arch]
    budget = cs.zoo_param_budget(arch)
    assert budget == (80e9 - cs.MIXTRAL_PREFILL_PEAK_ABOVE - 1.5e9 if arch == "mixtral-8x22b"
                      else cs.ZOO_PARAM_BYTES_MAX)

    def held(n_layers, engine):
        params = init_lm_params(0, dataclasses.replace(full, n_layers=n_layers), "meta")
        return _bytes(params) + (_bytes(cast_for_compute(params)) if engine else 0)

    for n_layers, engine in ((prefill_layers, False), (engine_layers, True)):
        assert 1 <= n_layers <= full.n_layers
        assert held(n_layers, engine) <= budget, (n_layers, engine)
        if n_layers < full.n_layers:
            assert held(n_layers + 1, engine) > budget, (n_layers, engine)
        assert cs.zoo_param_bytes(full, n_layers, engine) == held(n_layers, engine)
    assert engine_layers <= prefill_layers
    if prefill_layers < full.n_layers:
        assert (arch, "prefill_32k", None, prefill_layers) in cs.ROOFLINE_RUNS


# a loop as cuobjdump -sass prints one (sm_90a): labels, a predicated
# backward branch, each instruction's address and its encoding's two words
SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_123threefry_uniform_kernelILb0EEEvPKjPvix
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                   /* 0x00000a00ff017b82 */
                                                                              /* 0x000fe40000000800 */
        /*0010*/                   IMAD.MOV.U32 R4, RZ, RZ, R0 ;            /* 0x000000ffff047224 */
.L_x_1:
        /*0020*/                   IADD3 R5, R2, R7, RZ ;                   /* 0x0000000702057210 */
        /*0030*/                   SHF.L.W.U32.HI R6, R5, 0xd, R5 ;         /* 0x0000000d05067819 */
        /*0040*/                   LOP3.LUT R6, R6, R5, RZ, 0x3c, !PT ;     /* 0x0000000506067212 */
        /*0050*/                   IMAD.IADD R7, R6, 0x1, R5 ;              /* 0x0000000106077824 */
        /*0060*/                   FADD R8, R7, -1 ;                        /* 0x bf80000007087421 */
        /*0070*/                   STG.E desc[UR4][R2.64], R8 ;             /* 0x0000000802007986 */
        /*0080*/              @!P0 BRA `(.L_x_1) ;                          /* 0xfffffffc00fc8947 */
        /*0090*/                   EXIT ;                                   /* 0x000000000000794d */
.L_x_2:
        /*00a0*/                   BRA `(.L_x_2);                           /* 0xfffffffc00fc7947 */
\t\tFunction : _ZN12_GLOBAL__N_123threefry_uniform_kernelILb1EEEvPKjPvix
        /*0000*/                   IADD3 R5, R2, R7, RZ ;                   /* 0x0000000702057210 */
        /*0010*/                   STG.E.64 desc[UR4][R2.64], R8 ;          /* 0x0000000802007986 */
        /*0020*/                   STG.E.64 desc[UR4][R4.64], R8 ;          /* 0x0000000802007986 */
        /*0030*/                   LOP3.LUT R6, R6, R5, RZ, 0x3c, !PT ;     /* 0x0000000506067212 */
        /*0040*/                   ISETP.GE.AND P0, PT, R6, R9, PT ;        /* 0x000000090600720c */
        /*0050*/               @P0 BRA 0x0 ;                                /* 0xfffffffc00fc0947 */
        /*0060*/                   EXIT ;                                   /* 0x000000000000794d */
"""

# the redesigned kernel's shape: per instantiation (dtype, counters a thread)
# a main loop of 16-byte stores (four floats, or two doubles twice) and a
# scalar tail loop; the one-counter instantiation stores one float a trip
SASS_VECTOR = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_123threefry_uniform_kernelILb0ELi4EEEvPKjPvijjxNS_5MultsE
        /*0000*/                   LDC R1, c[0x0][0x28] ;                   /* 0x00000a00ff017b82 */
.L_x_3:
        /*0010*/                   IMAD R5, R2, c[0x0][0x180], R7 ;         /* 0x0000600002057a24 */
        /*0020*/                   IMAD.WIDE.U32 R8, R5, c[0x0][0x184], RZ ; /* 0x0000610005087a25 */
        /*0030*/                   LOP3.LUT R6, R8, R9, R5, 0xf6, !PT ;     /* 0x0000000908067212 */
        /*0040*/                   SHF.L.W.U32.HI R7, R6, 0xf, R6 ;         /* 0x0000000f06077819 */
        /*0050*/                   LOP3.LUT R7, R7, R5, RZ, 0x3c, !PT ;     /* 0x0000000507077212 */
        /*0060*/                   IMAD.HI.U32 R10, R7, c[0x0][0x1a4], R12 ; /* 0x0000690007107a27 */
        /*0070*/                   STG.E.128 desc[UR4][R2.64], R8 ;         /* 0x0000000802007986 */
        /*0080*/                   IADD3 R4, R4, -0x1, RZ ;                 /* 0xffffffff04047810 */
        /*0090*/                   ISETP.NE.AND P0, PT, R4, RZ, PT ;        /* 0x000000ff0400720c */
        /*00a0*/               @P0 BRA `(.L_x_3) ;                          /* 0xfffffffc00fc0947 */
.L_x_4:
        /*00b0*/                   IADD3 R5, R2, R7, RZ ;                   /* 0x0000000702057210 */
        /*00c0*/                   STG.E desc[UR4][R2.64], R8 ;             /* 0x0000000802007986 */
        /*00d0*/                   ISETP.GE.AND P0, PT, R6, R9, PT ;        /* 0x000000090600720c */
        /*00e0*/              @!P0 BRA `(.L_x_4) ;                          /* 0xfffffffc00fc8947 */
        /*00f0*/                   EXIT ;                                   /* 0x000000000000794d */
\t\tFunction : _ZN12_GLOBAL__N_123threefry_uniform_kernelILb0ELi1EEEvPKjPvijjxNS_5MultsE
.L_x_5:
        /*0000*/                   IADD3 R5, R2, R7, RZ ;                   /* 0x0000000702057210 */
        /*0010*/                   IMAD R6, R5, c[0x0][0x180], R5 ;         /* 0x0000600005067a24 */
        /*0020*/                   STG.E desc[UR4][R2.64], R8 ;             /* 0x0000000802007986 */
        /*0030*/               @P0 BRA `(.L_x_5) ;                          /* 0xfffffffc00fc0947 */
        /*0040*/                   EXIT ;                                   /* 0x000000000000794d */
\t\tFunction : _ZN12_GLOBAL__N_123threefry_uniform_kernelILb1ELi4EEEvPKjPvijjxNS_5MultsE
.L_x_6:
        /*0000*/                   IMAD R5, R2, c[0x0][0x180], R7 ;         /* 0x0000600002057a24 */
        /*0010*/                   LOP3.LUT R6, R8, R9, R5, 0xf6, !PT ;     /* 0x0000000908067212 */
        /*0020*/                   STG.E.128 desc[UR4][R2.64], R8 ;         /* 0x0000000802007986 */
        /*0030*/                   STG.E.128 desc[UR4][R2.64+0x1000], R12 ; /* 0x0010000c02007986 */
        /*0040*/               @P0 BRA `(.L_x_6) ;                          /* 0xfffffffc00fc0947 */
.L_x_7:
        /*0050*/                   IADD3 R5, R2, R7, RZ ;                   /* 0x0000000702057210 */
        /*0060*/                   STG.E.64 desc[UR4][R2.64], R8 ;          /* 0x0000000802007986 */
        /*0070*/               @P1 BRA `(.L_x_7) ;                          /* 0xfffffffc00fc1947 */
        /*0080*/                   EXIT ;                                   /* 0x000000000000794d */
"""


def test_sass_loops_counts_each_innermost_loop(monkeypatch):
    """Labels or absolute addresses as branch targets, predicates dropped,
    opcodes without their modifiers; the self-branch after EXIT is a loop
    of one instruction and holds no store; threefry_sass_facts reads the
    storing loop of each kernel, and of the redesigned kernel's the main
    loop beside a scalar tail loop."""
    cs = _chip_smoke()
    kernels = cs.sass_functions(SASS)
    assert sorted(kernels) == [
        "_ZN12_GLOBAL__N_123threefry_uniform_kernelILb0EEEvPKjPvix",
        "_ZN12_GLOBAL__N_123threefry_uniform_kernelILb1EEEvPKjPvix"]
    f32, f64 = (cs.sass_loops(lines) for lines in kernels.values())
    assert f32["instructions"] == 11
    assert f32["loops"] == [
        {"instructions": 7, "opcodes": {"IADD3": 1, "SHF": 1, "LOP3": 1, "IMAD": 1, "FADD": 1,
                                        "STG": 1, "BRA": 1}},
        {"instructions": 1, "opcodes": {"BRA": 1}}]
    assert f64["loops"] == [{"instructions": 6, "opcodes": {
        "IADD3": 1, "STG": 2, "LOP3": 1, "ISETP": 1, "BRA": 1}}]
    # f64: two stores a trip
    monkeypatch.setattr(cs, "cuobjdump_sass", lambda build, name: SASS)
    facts = cs.threefry_sass_facts(build=None)
    assert (facts["float32"]["int_alu_per_elem"], facts["float32"]["int_fma_per_elem"]) == (3, 1)
    assert (facts["float64"]["int_alu_per_elem"], facts["float64"]["int_fma_per_elem"]) == (1.5, 0)
    assert (facts["float32"]["kernel_int_alu"], facts["float32"]["kernel_int_fma"]) == (3, 2)

    # the redesigned kernel: the main loop is the one that holds the widest
    # store (STG.E.128 beside the tail loop's STG.E), its elements a trip
    # the stores' bits over the element's; keyed by dtype for the most
    # counters a thread, the one-counter instantiation apart
    vec = cs.sass_loops(cs.sass_functions(SASS_VECTOR)[
        "_ZN12_GLOBAL__N_123threefry_uniform_kernelILb0ELi4EEEvPKjPvijjxNS_5MultsE"])
    assert [lp["instructions"] for lp in vec["loops"]] == [10, 4]
    assert vec["loop_stores"] == [{"STG.E.128": 1}, {"STG.E": 1}]
    assert [cs.store_bits(m) for m in ("STG.E.128", "STG.E.64", "STG.E", "STG.E.U8")] == [
        128, 64, 32, 8]
    monkeypatch.setattr(cs, "cuobjdump_sass", lambda build, name: SASS_VECTOR)
    facts = cs.threefry_sass_facts(build=None)
    assert sorted(facts) == ["float32", "float32_counters_1", "float64"]
    f32, f64, one = facts["float32"], facts["float64"], facts["float32_counters_1"]
    assert (f32["elements_per_trip"], f64["elements_per_trip"], one["elements_per_trip"]) == (
        4, 4, 1)
    # main loop: IADD3, SHF, LOP3 x 2, ISETP on the INT32 pipe; IMAD,
    # IMAD.WIDE, IMAD.HI on the FMA pipe
    assert (f32["int_alu_per_elem"], f32["int_fma_per_elem"]) == (5 / 4, 3 / 4)
    assert f32["stores"] == {"STG.E.128": 1}
    assert f32["tail_loops"] == [{"instructions": 4, "opcodes": {
        "IADD3": 1, "STG": 1, "ISETP": 1, "BRA": 1}}]
    assert (f64["int_alu_per_elem"], f64["int_fma_per_elem"]) == (1 / 4, 1 / 4)
    assert len(f64["tail_loops"]) == 1
    assert (one["int_alu_per_elem"], one["int_fma_per_elem"]) == (1, 1)
    assert one["tail_loops"] == []
    # two loops with the widest store: no main loop to name
    monkeypatch.setattr(cs, "cuobjdump_sass", lambda build, name: SASS_VECTOR.replace(
        "STG.E desc[UR4][R2.64], R8 ;        ", "STG.E.128 desc[UR4][R2.64], R8 ;    "))
    with pytest.raises(RuntimeError, match="widest store"):
        cs.threefry_sass_facts(build=None)


@pytest.mark.parametrize("arch", CUT_ZOO)
def test_train_cuts_are_the_deepest_that_fit_the_peak(arch):
    """The cut train cells' depths: peak_train_bytes (the f32 params,
    grads, m and v counted on meta, and what a measured step held above
    them) fits PEAK_BYTES_MAX at the cell's depth and not one layer deeper;
    the card-vs-CPU depth cut runs at 2 layers (B 1, S 512: nemotron-4-15b's
    fits beside AdamW's state there, where its full-width step does not),
    mixtral-8x22b's at 1, since AdamW's state at 2 does not fit the card."""
    cs = _chip_smoke()
    full = get_config(arch)
    n_layers = _train_layers(cs)[arch]
    cell = next(c for c in cs.TRAIN_CELLS if c[0] == arch)
    cut_layers = 1 if arch == "mixtral-8x22b" else 2
    assert cell == (arch, cut_layers, n_layers, cs.TRAIN_STEPS_SHORT)
    assert cs.train_state_bytes(full, cut_layers) <= cs.PEAK_BYTES_MAX
    if arch == "mixtral-8x22b":
        assert cs.train_state_bytes(full, 2) > cs.PEAK_BYTES_MAX
    assert 1 <= n_layers < full.n_layers
    assert cs.peak_train_bytes(full, n_layers) <= cs.PEAK_BYTES_MAX
    assert cs.peak_train_bytes(full, n_layers + 1) > cs.PEAK_BYTES_MAX
    params = init_lm_params(0, dataclasses.replace(full, n_layers=n_layers), "meta")
    assert cs.train_state_bytes(full, n_layers) == 4 * _bytes(params)
    layer = (cs.MIXTRAL_TRAIN_LAYER if arch == "mixtral-8x22b" else cs.DENSE_TRAIN_LAYER[arch])
    assert layer == (2, 4096, full.n_heads, full.n_kv, full.head_dim)
    if arch == "mixtral-8x22b":  # its window reaches every causal pair at S 4,096
        assert cs.MIXTRAL_WINDOW == full.window >= layer[1]


@pytest.mark.parametrize("arch", CUT_ZOO)
def test_dense_train_launches_are_a_steps_attention_calls(arch, monkeypatch):
    """At the cell's depth and a reduced width, one train step (accum 2,
    remat "full") calls chunked_attention as often as
    expected_train_launches has the card launch flash's training forward,
    each call causal with the config's window (none but mixtral-8x22b's),
    and the backward kernels half as often."""
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config(arch).reduced(), accum_steps=cs.TRAIN_ACCUM,
                              n_layers=_train_layers(cs)[arch])
    assert cfg.remat_policy == "full"
    calls = []
    plain = tlm.chunked_attention

    def counted(*args, **kwargs):
        calls.append((kwargs.get("causal", True), kwargs.get("window")))
        return plain(*args, **kwargs)

    monkeypatch.setattr(tlm, "chunked_attention", counted)
    params = init_lm_params(0, cfg, "cpu")
    make_train_step(cfg)(params, adamw_init(params), synthetic_batch(cfg, 4, 16, seed=0))
    want = cs.expected_train_launches(cfg, cs.TRAIN_ACCUM)
    assert want["flash_attention_train"] == len(calls) == 2 * 2 * cfg.n_layers
    assert want["flash_attention_bwd_dq"] == want["flash_attention_bwd_dkdv"] == len(calls) // 2
    assert set(calls) == {(True, cfg.window)}


def test_train_cells_and_roofline_runs_agree():
    """Every train cell's full-width run has its roofline run at the same
    depth, and every train_4k roofline run is a train cell's."""
    cs = _chip_smoke()
    cells = {(arch, "train_4k", cs.TRAIN_ACCUM, layers)
             for arch, _, layers, _ in cs.TRAIN_CELLS}
    runs = {run for run in cs.ROOFLINE_RUNS if run[1] == "train_4k"}
    assert cells == runs
    assert len(cs.ROOFLINE_RUNS) == len(set(cs.ROOFLINE_RUNS))
    for arch, layers in _train_layers(cs).items():
        assert (arch, "train_4k", cs.TRAIN_ACCUM, layers) in runs


def test_phases_keep_the_default_order_and_refuse_an_unknown_name(capsys, monkeypatch):
    """No option: every phase in PHASES' order, which is the order of main's
    phase blocks; a selection adds what it needs and keeps that order; an
    unknown name exits 2 naming it."""
    cs = _chip_smoke()
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])  # a run without arguments
    assert cs.select_phases(None) == cs.select_phases([]) == cs.PHASES
    source = Path(cs.__file__).read_text()
    main = source[source.index("def main("):]
    blocks = re.findall(r'^    if "(\w+)" in run:$', main, flags=re.M)
    assert tuple(blocks) == cs.PHASES
    assert cs.select_phases(["--phases", "train"]) == ("train",)
    assert cs.select_phases(["--phases", "roofline,train,zoo"]) == ("zoo", "train", "roofline")
    assert cs.select_phases(["--phases", "topology"]) == ("star", "topology")
    assert cs.select_phases(["--phases", "trace"]) == ("kernels", "main", "trace")
    assert cs.select_phases(["--phases", "probe"]) == ("probe",)
    assert cs.select_phases(["--phases", "zoo,probe,times"]) == ("kernels", "times", "probe",
                                                                  "zoo")
    for bad in ("trian", "train,nope", ""):
        with pytest.raises(SystemExit) as exit_info:
            cs.select_phases(["--phases", bad])
        assert exit_info.value.code == 2
        assert "unknown phase" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exit_info:
        cs.main(["--phases", "nope"])
    assert exit_info.value.code == 2


def test_probe_phase_sits_after_trace_and_before_zoo():
    """The probe phase runs while the lm phase's params are on the card:
    after trace, which still reads them, and before the zoo, which frees
    them; it needs no other phase (it draws its own params without lm)."""
    cs = _chip_smoke()
    order = list(cs.PHASES)
    assert order.index("lm") < order.index("trace") < order.index("probe") == \
        order.index("zoo") - 1
    assert "probe" not in cs.PHASE_NEEDS and not any("probe" in v for v in cs.PHASE_NEEDS.values())
    source = Path(cs.__file__).read_text()
    main = source[source.index("def main("):]
    assert main.index('probe = probe_phase(dev, ops, tfa, lm, cpu_side)') < main.index(
        "lm = None  # granite's params freed before the zoo's")


def test_probe_shapes_and_flash_launches():
    """granite-3-2b's width gives the probe d = 2,048, T = 2,098,176 and the
    example spec's k = 8 d = 16,384; one backbone call launches flash once a
    layer, 40 times, as a forward through the blocks calls attention."""
    cs = _chip_smoke()
    full = get_config(cs.PROBE_ARCH)
    assert cs.probe_dims(full) == {"clients": 8, "n_i": 64, "d": 2048, "t": 2_098_176,
                                   "k": 16_384}
    assert cs.probe_flash_launches(full) == 40 == full.n_layers
    cfg = dataclasses.replace(full.reduced(), n_layers=3)
    calls = []
    plain = tlm.chunked_attention

    def counted(*args, **kwargs):
        calls.append(kwargs.get("window"))
        return plain(*args, **kwargs)

    import unittest.mock

    with unittest.mock.patch.object(tlm, "chunked_attention", counted):
        probe = cs.probe_example()
        labels, tokens = probe.probe_data(cfg, 2, 3)
        feats = probe.backbone_features(init_lm_params(0, cfg, "cpu"), cfg, tokens)
    assert len(calls) == cs.probe_flash_launches(cfg) == 3
    assert feats.shape == (6, cfg.d_model) and feats.dtype == torch.float64
    assert tokens.shape == (6, probe.SEQ) and set(np.unique(labels)) <= {-1.0, 1.0}


def test_count_syncs_at_names_the_line_of_each_sync(monkeypatch):
    """Each "synchronizing" warning is counted once, by the innermost frame
    that raised it, with its message (the debug mode itself is the card's:
    set here to do nothing); other warnings are not counted."""
    import warnings

    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)

    def inner():
        warnings.warn("called a synchronizing CUDA operation")

    def step():
        inner()
        warnings.warn("an unrelated warning")
        inner()
        warnings.warn("called a synchronizing CUDA operation")

    count, sites = cs.count_syncs_at(step)
    assert count == 3 and sorted(sites.values()) == [1, 2]
    assert sorted(site.split(" (")[1].split(")")[0] for site in sites) == ["inner", "step"]
    assert all(site.endswith(": called a synchronizing CUDA operation") for site in sites)
    assert cs.count_syncs(lambda: None) == 0


# the H100's opt-in shared memory a block (cudaDevAttrMaxSharedMemoryPerBlockOptin,
# 227 KiB), as phase 3 reads it on the card
H100_SMEM_OPTIN = 232_448


def test_toplek_plan_at_the_probe_is_the_spread_route():
    """TopLEK's host-side plan at the probe's (2,098,176, 16,384): the keys
    (8.39 MB) exceed the opt-in, and so do the composites and prefix sums
    (131,072 B each) together; the composites alone fit, so it takes the
    spread route (path 3: the composites in shared memory, the prefix sums
    not stored; a scratch of the tallies and T candidates a client).  So do
    d = 350 (the former path 1) and the keys' edge."""
    from repro_torch.kernels.compressor_select import (SPREAD_HEAD_BYTES, TOPLEK_SPREAD_STATIC_SMEM,
                                                       TOPLEK_STATIC_SMEM, toplek_plan_for)

    cs = _chip_smoke()
    dims = cs.probe_dims(get_config(cs.PROBE_ARCH))
    t = dims["t"]
    assert toplek_plan_for(t, dims["k"], H100_SMEM_OPTIN) == (3, SPREAD_HEAD_BYTES + 8 * t)
    assert 2 * 131_072 > H100_SMEM_OPTIN - TOPLEK_STATIC_SMEM
    assert 131_072 <= H100_SMEM_OPTIN - TOPLEK_SPREAD_STATIC_SMEM
    w8a_t = 301 * 302 // 2
    assert toplek_plan_for(w8a_t, 8 * 301, H100_SMEM_OPTIN) == (0, 0)
    d350 = 350 * 351 // 2
    assert toplek_plan_for(d350, 8 * 350, H100_SMEM_OPTIN)[0] == 3
    # at the keys' edge: path 0 while keys and composites fit, then path 3
    budget = H100_SMEM_OPTIN - TOPLEK_STATIC_SMEM
    fits = (budget - 8 * 4096) // 4 // 16 * 16
    assert toplek_plan_for(fits, 4096, H100_SMEM_OPTIN)[0] == 0
    assert toplek_plan_for(fits + 16, 4096, H100_SMEM_OPTIN)[0] == 3


def test_toplek_plan_at_the_probe_is_path_2():
    """Path 2 at the probe's T = 2,098,176 (the composites and prefix sums
    in a 262,144-byte-a-client scratch, one block a client) is left to a k
    whose composites alone exceed the opt-in: 32,768 (262,144 B), phase
    3's case that keeps path 2 there; so is k = T at w8a's T."""
    from repro_torch.kernels.compressor_select import TOPLEK_SPREAD_STATIC_SMEM, toplek_plan_for

    cs = _chip_smoke()
    t = cs.probe_dims(get_config(cs.PROBE_ARCH))["t"]
    assert 262_144 > H100_SMEM_OPTIN - TOPLEK_SPREAD_STATIC_SMEM
    assert toplek_plan_for(t, 32_768, H100_SMEM_OPTIN) == (2, 2 * 262_144)
    w8a_t = 301 * 302 // 2
    assert toplek_plan_for(w8a_t, w8a_t, H100_SMEM_OPTIN) == (2, 8 * 65_536 + 8 * w8a_t)


def test_probe_bounds_count_each_kernels_bytes_and_operations():
    """The bounds phase 6 gives the probe's SYRK and TopLEK: SYRK reads z
    and hw and writes the packed H (142.68 MB) for 2.15 GFLOP on the FP64
    tensor cores: bytes, 0.0426 ms at 3.35 TB/s; TopLEK reads u and writes
    u_hat (268.57 MB): bytes, 0.0802 ms."""
    cs = _chip_smoke()
    counts = cs.fednl_round_counts(8, 64, 2048, 16_384)
    t = 2_098_176
    assert counts["hessian_syrk_packed"][:2] == ((8 * 64 * 2048 + 8 * 64 + 8 * t) * 8,
                                                 2 * 64 * t * 8) == (142_675_968, 2_148_532_224)
    assert counts["select_toplek"][0] == 8 * t * 16 + 8 * 12 == 268_566_624
    bounds = cs.fednl_round_bounds(8, 64, 2048, 16_384)
    assert bounds["hessian_syrk_packed"][1] == bounds["select_toplek"][1] == "bytes"
    assert bounds["hessian_syrk_packed"][0] == pytest.approx(142_675_968 / 3.35e12 * 1e3)
    assert bounds["hessian_syrk_packed"][0] == pytest.approx(0.0426, abs=5e-5)
    assert bounds["select_toplek"][0] == pytest.approx(0.0802, abs=5e-5)
    flops_ms = counts["hessian_syrk_packed"][1] / cs.FP64_TENSOR_FLOPS * 1e3
    assert bounds["hessian_syrk_packed"][0] > flops_ms  # 0.0321 ms of operations


@pytest.fixture(scope="module")
def chip_smoke_worker():
    """chip_smoke imported as a module (its jobs pickle by name) and one
    CpuSide worker at this process's thread count."""
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke

        side = chip_smoke.CpuSide(threads=torch.get_num_threads())
        yield chip_smoke, side
        side.close()
    finally:
        sys.path.remove(root)


def _job(cs, family: str):
    """A job of each kind at a reduced config: (function, the tree of
    tensors the worker is handed first or None, the job's other
    arguments)."""
    rng = np.random.default_rng(5)
    if family == "lm":
        cut = dataclasses.replace(get_config("granite-3-2b").reduced(), n_layers=2)
        return (cs.lm_cpu_side, init_lm_params(0, cut, "cpu"),
                (cut, rng.integers(0, cut.vocab, size=(2, 24))))
    if family == "zoo":  # the moe: its router inputs recorded too
        cut = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(), n_layers=2)
        return (cs.zoo_cpu_side, cast_for_compute(init_lm_params(0, cut, "cpu")),
                (cut, cs.zoo_inputs(cut, 2, 24, rng, "cpu")))
    if family == "zoo_long":  # mixtral's: the moe, and (e)'s long_500k decode from a full ring
        cut = dataclasses.replace(get_config("mixtral-8x22b").reduced(), n_layers=2)
        return (cs.zoo_cpu_side, cast_for_compute(init_lm_params(0, cut, "cpu")),
                (cut, cs.zoo_inputs(cut, 2, 24, rng, "cpu"), True))
    if family == "fednl":  # phase 10 (c)'s kind of run: FedNL-PP with RandK, dropouts, a star
        from repro_torch.api import CompressorSpec, DataSpec, ExperimentSpec, FaultSpec

        spec = ExperimentSpec(data=DataSpec(dataset="tiny"), algorithm="fednl-pp", tau=3,
                              rounds=4, compressor=CompressorSpec("randk"),
                              fault=FaultSpec(drop_prob=0.2), on_dropout="resample",
                              backend="star-loopback")
        return cs.solve_cpu_side, None, (spec, spec.data.build())
    if family == "probe":  # the probe phase's features at the depth cut
        cut = dataclasses.replace(get_config("granite-3-2b").reduced(), n_layers=2)
        return (cs.probe_cpu_side, init_lm_params(0, cut, "cpu"),
                (cut, cs.probe_example().probe_data(cut, 2, 4)[1]))
    cut = dataclasses.replace(get_config("granite-3-2b").reduced(), n_layers=2, accum_steps=1)
    return cs.train_cpu_side, init_lm_params(0, cut, "cpu"), (cut, synthetic_batch(cut, 1, 24))


def _held_keys() -> list:
    """A job: the keys the worker holds (chip_smoke._HELD)."""
    import chip_smoke

    return sorted(chip_smoke._HELD)


def test_cpu_worker_runs_one_side_at_a_time_beside_its_hand_overs(chip_smoke_worker):
    """Two sides started back to back compute one after the other in the
    worker's run chain, while a hand-over goes through beside them; each is
    collected in order; what a side raised is raised by its collection."""
    cs, side = chip_smoke_worker
    slow = [side.start(_sleep_then_stamp, f"slow{i}", 0.5) for i in range(2)]
    t0 = time.perf_counter()
    assert side.hand_over("beside", {"x": torch.arange(4.0)}) >= 0
    assert time.perf_counter() - t0 < 0.5  # not behind the sleeps
    assert not slow[1].done()
    (a, _), (b, _) = slow[0].result(), slow[1].result()
    assert b["start"] >= a["end"]  # one after the other
    assert side.submit(_held_keys).result()[0] == ["beside"]
    side.submit(cs.put_held, "beside", {"x": torch.zeros(4)}).result()
    failing = side.start(_sleep_then_stamp, "bad", -1.0)
    with pytest.raises(ValueError, match="sleep length"):
        failing.result()


def _sleep_then_stamp(key: str, seconds: float) -> dict:
    """A CPU side for the run chain's test: sleeps, and says when."""
    start = time.time()
    time.sleep(seconds)
    return {"start": start, "end": time.time()}


def _same_bits(got, want) -> bool:
    if isinstance(want, dict):
        return sorted(got) == sorted(want) and all(_same_bits(got[k], want[k]) for k in want)
    if isinstance(want, list):
        return len(got) == len(want) and all(_same_bits(g, w) for g, w in zip(got, want))
    if not torch.is_tensor(want):
        return got == want
    return got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("family", ["lm", "zoo", "zoo_long", "train", "fednl", "probe"])
def test_cpu_worker_gives_the_in_process_result_bit_for_bit(chip_smoke_worker, family):
    """Each CPU side in the spawned worker gives what the same calls give in
    this process, bit for bit: the worker is handed its tree first
    (hand_over: its own copy, kept under a key), the LM sides start in its
    run chain and are collected, and a train cut's gradient comes back into
    the caller's tensors (take_back); two FedNL runs queue and come back in
    order; each result with the worker's thread count and times."""
    cs, side = chip_smoke_worker
    fn, tree, args = _job(cs, family)
    if family == "fednl":
        first, second = side.submit(fn, *args), side.submit(fn, *args)
        (got, worker), (again, _) = first.result(), second.result()
        want = fn(*args)

        def fields(rep):
            return [(r.round, r.f, r.sent_bits, r.participants, r.dropped, r.x.tobytes())
                    for r in rep.records] + [rep.x.tobytes()]

        assert fields(got) == fields(again) == fields(want)
    else:
        assert side.hand_over(family, tree) >= 0
        run = side.start(fn, family, *args)
        got, worker = run.result()
        assert run.side is side and not any(k.startswith(family + "/run")
                                            for k in side.submit(_held_keys).result()[0])
        cs.hold_on_host(family, tree)  # the same calls in this process
        want = fn(family, *args)
        assert sorted(got) == sorted(want)
        for key in want:
            if key != "seconds":
                assert _same_bits(got[key], want[key]), key
        if family.startswith("zoo"):  # two layers' router inputs in the prefill and each step
            assert len(got["prefill_calls"]) == len(got["moe_module"]) == 2
            assert all(len(c) == 2 for c in got["decode_calls"])
            # each layer's moe_apply as the prefill ran it: moe_module_outputs on its input
            cut = args[0]
            alone = cs.moe_module_outputs(cut, tree, got["prefill_calls"])
            assert _same_bits(got["moe_module"], alone)
        if family == "zoo_long":
            assert len(got["long_decode"]) == len(got["long_decode_calls"]) == cs.LONG_STEPS
            assert got["long_cache"]["pos"] == cs.LONG_POS + cs.LONG_STEPS
        if family == "probe":  # the example's features of the same params and tokens
            assert _same_bits(got["feats"], cs.probe_example().backbone_features(tree, *args))
        if family == "train":
            back = tree_map(lambda v: torch.full_like(v, float("nan")), tree)
            side.take_back(family + "/grads", back)
            assert _same_bits(back, cs._HELD.pop(family + "/grads"))
    assert worker["job"] == fn.__name__ and worker["threads"] == torch.get_num_threads()
    assert worker["submit_to_result_s"] >= worker["waited_s"] >= 0
