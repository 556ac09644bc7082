"""``analysis.cost``'s charges of indexed ops and its temporaries, against
``repro.analysis.hlo``.

``analyze_hlo`` charges a gather or dynamic slice twice its result, and a
scatter or dynamic-update-slice twice its update, at most twice its
result (``src/repro/analysis/hlo.py``).  Each small program here runs in
both packages: the port's op is counted on ``meta`` (nothing allocated),
and the reference's instruction, as XLA compiles the same program, is
charged by ``analyze_hlo``'s own parser.  The sizes clear the
reference's 16 MiB on-chip threshold, below which it charges nothing,
and are fp32: XLA's CPU backend computes a bf16 gather or scatter in
fp32.
Then the smoke decode step: its cache write is charged twice the update,
its cache read twice the rows read, and its temporaries are the peak
less the arguments less the outputs that are not the cache it updates
in place.
"""
import re

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis import hlo as ref_hlo
from repro_torch.analysis import cost
from repro_torch.configs.registry import get_config
from repro_torch.core.grid import Grid
from repro_torch.launch import dryrun
from repro_torch.models.config import ShapeConfig

N = 4096
S = jax.ShapeDtypeStruct
F32, I32 = jnp.float32, jnp.int32


def _meta(spec):
    dtype = {F32: torch.float32, I32: torch.int64}[spec.dtype.type]
    return torch.empty(spec.shape, dtype=dtype, device="meta")


def _put_rows(b, i, v):
    b[i] = v


def _put_ring(buf, rows, slot, upd):
    buf[rows, :, slot, :] = upd


def _scatter_add(b, i, v):
    b.scatter_add_(1, i, v)


#: name -> (the port's op, its aten name, the reference's program, the
#: reference's opcode, argument specs, donated reference arguments)
CASES = {
    "rows": (lambda x, i: x[i], "aten.index", lambda x, i: x[i], "gather",
             (S((N, N), F32), S((2048,), I32)), ()),
    "take_along": (lambda x, i: torch.gather(x, 1, i), "aten.gather",
                   lambda x, i: jnp.take_along_axis(x, i, axis=1), "gather",
                   (S((N, N), F32), S((N, 1024), I32)), ()),
    "index_select": (lambda x, i: torch.index_select(x, 0, i),
                     "aten.index_select",
                     lambda x, i: jnp.take(x, i, axis=0), "gather",
                     (S((N, N), F32), S((3000,), I32)), ()),
    "put_rows": (_put_rows, "aten.index_put_",
                 lambda b, i, v: b.at[i].set(v), "scatter",
                 (S((N, N), F32), S((1024,), I32), S((1024, N), F32)), (0,)),
    "put_ring": (_put_ring, "aten.index_put_",
                 lambda b, r, s, u: b.at[r, :, s, :].set(u), "scatter",
                 (S((8192, 8, 64, 128), F32), S((8192,), I32),
                  S((8192,), I32), S((8192, 8, 128), F32)), (0,)),
    "scatter_add": (_scatter_add, "aten.scatter_add_",
                    lambda b, i, v: b.at[jnp.arange(N)[:, None], i].add(v),
                    "scatter",
                    (S((N, N), F32), S((N, 1024), I32), S((N, 1024), F32)),
                    (0,)),
}


def _reference_charge(fn, specs, donate, opcode) -> float:
    """``analyze_hlo``'s charge of the one ``opcode`` instruction XLA
    compiles ``fn`` to: the instruction alone in a computation whose
    parameters are its operands, parsed by ``analyze_hlo``'s own
    parser (the computation XLA puts it in holds other work too)."""
    text = jax.jit(fn, donate_argnums=donate).lower(*specs).compile().as_text()
    shapes, found = {}, []
    for line in text.splitlines():
        m = ref_hlo._INSTR_RE.match(line)
        if m:
            shapes[m.group(1)] = m.group(2)
            if m.group(3) == opcode:
                found.append(m)
    assert len(found) == 1, [m.group(0) for m in found]
    name, shape, _, rest = found[0].groups()
    operands = re.findall(r"%([\w.\-]+)", rest.split("), ")[0])
    lines = [f"%only () -> {shape} {{"]
    lines += [f"  %{o} = {shapes[o]} parameter({i})"
              for i, o in enumerate(operands)]
    lines += [f"  ROOT %{name} = {shape} {opcode}({rest}", "}"]
    return ref_hlo._parse_computations("\n".join(lines))["only"].bytes_written


@pytest.mark.parametrize("case", list(CASES))
def test_indexed_op_charged_as_reference(case):
    fn, aten, ref_fn, opcode, specs, donate = CASES[case]
    want = _reference_charge(ref_fn, specs, donate, opcode)
    _, wc, _ = cost.analyze_step(fn, *map(_meta, specs))
    calls, flops, nbytes = wc.by_op[aten]
    assert (calls, flops) == (1.0, 0.0)
    assert nbytes == want > 16 * 2**20


def test_overwrites_do_not_read_their_destination():
    """``copy_`` reads its source and writes its destination; an ``out=``
    product does not read ``out``."""
    a = torch.empty(64, 32, device="meta")
    b = torch.empty(32, 16, device="meta")
    y = torch.empty(64, 16, device="meta")
    half = torch.empty(64, 16, dtype=torch.bfloat16, device="meta")
    _, wc, _ = cost.analyze_step(
        lambda: (torch.mm(a, b, out=y), half.copy_(y)), device="meta")
    assert wc.by_op["aten.mm"][2] == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert wc.by_op["aten.copy_"][2] == (4 + 2) * 64 * 16


@pytest.fixture(scope="module")
def decode_count():
    cfg = get_config("llama3.2-1b", smoke=True)
    shape = ShapeConfig("d", 64, 4, "decode")
    ctx = dryrun.make_ctx(Grid.local("meta"), False)
    fn, args = dryrun.build_decode_cell(cfg, shape, ctx)
    _, wc, mem = cost.analyze_step(fn, *args)
    return cfg, shape, args, wc, mem


def test_decode_cache_write_is_charged_twice_the_update(decode_count):
    """Each layer writes one (B, Hkv, Dh) row of its K and its V ring
    (``index_put_``) and reads the rows it keeps (``index``): twice the
    update each, not the whole cache leaf."""
    cfg, shape, _, wc, _ = decode_count
    update = shape.global_batch * cfg.num_kv_heads * cfg.head_dim * 2  # bf16
    writes = 2 * cfg.num_layers  # K and V of every layer
    assert wc.by_op["aten.index_put_"] == [writes, 0.0, writes * 2 * update]
    assert wc.by_op["aten.index"][0] >= writes
    leaf = shape.global_batch * cfg.num_kv_heads * shape.seq_len * \
        cfg.head_dim * 2
    assert wc.by_op["aten.index_put_"][2] < leaf


def test_decode_temporaries_exclude_the_cache_updated_in_place(decode_count):
    """The cache is an argument and an output (updated in place):
    ``alias_size_in_bytes`` holds it, and the temporaries are the peak
    less the arguments less the other outputs, above 0."""
    _, _, args, _, mem = decode_count
    kv = sum(t.untyped_storage().nbytes() for t in cost._tensors(
        args[1], []) if t.is_floating_point())
    assert mem.alias_size_in_bytes >= kv > 0
    assert mem.temp_size_in_bytes == (
        mem.peak_live_bytes - mem.argument_size_in_bytes
        - (mem.output_size_in_bytes - mem.alias_size_in_bytes)) > 0
    assert mem.output_size_in_bytes - mem.alias_size_in_bytes > 0  # logits
