"""Program graph dumps (counterpart of ``paddle_tpu/fluid/debugger.py``;
reference: v2/fluid/debuger.py + graphviz.py — pprint the ProgramDesc and
draw the op graph as DOT)."""

from __future__ import annotations

from paddle_tpu_torch.fluid import framework

__all__ = ["pprint_program", "to_dot"]


def pprint_program(program=None) -> str:
    """Readable op listing per block (reference debuger.pprint_program_codes)."""
    program = program or framework.default_main_program()
    lines = []
    for bi, block in enumerate(program.blocks):
        lines.append(f"block {bi} (parent {block.parent_idx}):")
        for v in block.vars.values():
            flag = "persist " if v.persistable else ""
            lines.append(f"  var {v.name}: {v.dtype}{list(v.shape)} {flag}")
        for op in block.ops:
            ins = ", ".join(f"{s}={ns}" for s, ns in op.inputs.items())
            outs = ", ".join(f"{s}={ns}" for s, ns in op.outputs.items())
            lines.append(f"  op {op.type}({ins}) -> {outs}")
    return "\n".join(lines)


def to_dot(program=None, block_idx: int = 0) -> str:
    """DOT digraph of one block's op/var graph (reference graphviz.py);
    render with `dot -Tpng` or any graphviz viewer."""
    program = program or framework.default_main_program()
    block = program.blocks[block_idx]
    lines = ["digraph program {", "  rankdir=TB;",
             '  node [fontsize=10];']
    for v in block.vars.values():
        shape = "box3d" if v.persistable else "ellipse"
        lines.append(f'  "v_{v.name}" [label="{v.name}" shape={shape}];')
    for i, op in enumerate(block.ops):
        lines.append(f'  "op_{i}" [label="{op.type}" shape=box '
                     f'style=filled fillcolor=lightgrey];')
        for names in op.inputs.values():
            for n in names:
                if n:
                    lines.append(f'  "v_{n}" -> "op_{i}";')
        for names in op.outputs.values():
            for n in names:
                if n:
                    lines.append(f'  "op_{i}" -> "v_{n}";')
    lines.append("}")
    return "\n".join(lines)


# reference module name had the typo "debuger"; keep an alias
draw_block_graphviz = to_dot
