#!/usr/bin/env python
"""Pipeline description ⇄ pbtxt converter of the PyTorch/CUDA port.

Counterpart of the JAX package's ``tools/pipeline_convert.py``.  Parity
target: the reference's ``tools/development/parser/`` — a
flex/bison tool converting gst-launch pipeline strings to
mediapipe-style pbtxt graphs (``node: { calculator: "XCalculator"
input_stream/output_stream }``, toplevel.c/convert.c) and back.

This version goes through the port's parser (``parse_launch`` builds the
element graph on the ``meta`` device — nothing runs, no CUDA context
opens — so anything the runtime accepts converts), keeps the
reference's pbtxt shape (``calculator: "<factory>Calculator"``,
graph-level ``input_stream``/``output_stream`` for sources/sinks), and
completes the reference's open TODO ("Filling 'node_options' for detail
element info"): non-default element properties round-trip through
``node_options``.

Usage:
    python -m nnstreamer_tpu_torch.tools.pipeline_convert               # launch → pbtxt (stdin)
    python -m nnstreamer_tpu_torch.tools.pipeline_convert --from-pbtxt  # pbtxt → launch (stdin)
"""

from __future__ import annotations

import inspect
import re
import sys
from typing import Dict, List, Optional, Tuple


# -- graph model --------------------------------------------------------------

class Node:
    def __init__(self, name: str, factory: str,
                 props: Dict[str, str]):
        self.name = name
        self.factory = factory
        self.props = props
        # (own src pad or None, peer name, peer sink pad or None)
        self.outputs: List[Tuple[Optional[str], str, Optional[str]]] = []
        self.n_inputs = 0


def _non_default_props(el) -> Dict[str, str]:
    props = {}
    sig = inspect.signature(type(el).__init__)
    for p in sig.parameters.values():
        if p.name in ("self", "name", "props") or \
                p.kind == inspect.Parameter.VAR_KEYWORD:
            continue
        val = getattr(el, p.name, p.default)
        if val is None or val is p.default:
            continue
        if not isinstance(val, (str, int, float, bool)):
            continue  # runtime-only objects (callables, specs) don't ser
        if p.default is not inspect.Parameter.empty and val == p.default:
            continue
        props[p.name.rstrip("_").replace("_", "-")] = (
            str(val).lower() if isinstance(val, bool) else str(val))
    return props


def _graph_from_launch(desc: str) -> List[Node]:
    from nnstreamer_tpu_torch.runtime.parser import parse_launch

    p = parse_launch(desc, device="meta")
    nodes: Dict[str, Node] = {}
    for name, el in p.elements.items():
        nodes[name] = Node(name, el.FACTORY or type(el).__name__,
                           _non_default_props(el))
    for name, el in p.elements.items():
        multi_src = len(el.srcpads) > 1
        for pad in el.srcpads:
            if pad.peer is None:
                continue
            peer_el = pad.peer.element
            multi_sink = len(peer_el.sinkpads) > 1
            nodes[name].outputs.append((
                pad.name if multi_src else None,
                peer_el.name,
                pad.peer.name if multi_sink else None))
            nodes[peer_el.name].n_inputs += 1
    return [nodes[n] for n in p.elements]  # insertion order


# -- launch → pbtxt -----------------------------------------------------------

def launch_to_pbtxt(desc: str) -> str:
    nodes = _graph_from_launch(desc)
    out = []
    for n in nodes:
        if n.n_inputs == 0:
            out.append(f'input_stream: "{n.name}"')
    for n in nodes:
        if not n.outputs:
            out.append(f'output_stream: "{n.name}"')
    for n in nodes:
        lines = ["", "node: {",
                 f'\tcalculator: "{n.factory}Calculator"',
                 f'\tname: "{n.name}"']
        # input streams = the upstream nodes feeding us (reference
        # convention: streams are named after their producing node)
        for m in nodes:
            for spad, peer, dpad in m.outputs:
                if peer == n.name:
                    suffix = f":{dpad}" if dpad else ""
                    src = f"{m.name}:{spad}" if spad else m.name
                    lines.append(f'\tinput_stream: "{src}{suffix}"')
        if n.outputs or n.n_inputs == 0:
            lines.append(f'\toutput_stream: "{n.name}"')
        if n.props:
            lines.append("\tnode_options: {")
            for k, v in n.props.items():
                lines.append(f'\t\t{k}: "{_escape(v)}"')
            lines.append("\t}")
        lines.append("}")
        out.extend(lines)
    return "\n".join(out) + "\n"


# -- pbtxt → launch -----------------------------------------------------------

_TOKEN = re.compile(r'"(?:[^"\\]|\\.)*"|[{}:]|[^\s{}:"]+')


def _tokenize(text: str) -> List[str]:
    return _TOKEN.findall(text)


def _unquote(tok: str) -> str:
    if tok.startswith('"') and tok.endswith('"'):
        return re.sub(r"\\(.)", r"\1", tok[1:-1])
    return tok


def pbtxt_to_launch(text: str) -> str:
    toks = _tokenize(text)
    i = 0
    nodes: List[Node] = []

    def expect(t):
        nonlocal i
        if i >= len(toks) or toks[i] != t:
            raise ValueError(
                f"pbtxt: expected {t!r} at token {i} "
                f"({toks[i] if i < len(toks) else 'EOF'!r})")
        i += 1

    def parse_node() -> Node:
        nonlocal i
        expect("{")
        calc = name = None
        inputs: List[str] = []
        opts: Dict[str, str] = {}
        while i < len(toks) and toks[i] != "}":
            key = toks[i]
            i += 1
            expect(":")
            if key == "node_options":
                expect("{")
                while i < len(toks) and toks[i] != "}":
                    k = toks[i]
                    i += 1
                    expect(":")
                    if i >= len(toks):
                        raise ValueError("pbtxt: truncated node_options")
                    opts[k] = _unquote(toks[i])
                    i += 1
                expect("}")
                continue
            if i >= len(toks):
                raise ValueError(f"pbtxt: missing value for {key!r}")
            val = _unquote(toks[i])
            i += 1
            if key == "calculator":
                calc = val
            elif key == "name":
                name = val
            elif key == "input_stream":
                inputs.append(val)
            # output_stream is implied by the node name
        expect("}")
        if calc is None:
            raise ValueError("pbtxt: node without calculator")
        factory = calc[:-len("Calculator")] \
            if calc.endswith("Calculator") else calc
        node = Node(name or f"n{len(nodes)}", factory, opts)
        for s in inputs:
            # "<src>[:<srcpad>][:<sinkpad>]" — we emitted at most
            # "src:srcpad:sinkpad"; a plain stream is just "src"
            parts = s.split(":")
            src, spad, dpad = parts[0], None, None
            if len(parts) == 3:
                spad, dpad = parts[1], parts[2]
            elif len(parts) == 2:
                # ambiguity (reference streams have no pad info): treat
                # a sink_* suffix as OUR pad, else the producer's
                if parts[1].startswith("sink"):
                    dpad = parts[1]
                else:
                    spad = parts[1]
            node.n_inputs += 1
            node.outputs.append((spad, "<-" + src, dpad))  # temp marker
        return node

    while i < len(toks):
        key = toks[i]
        i += 1
        expect(":")
        if key == "node":
            nodes.append(parse_node())
        else:
            i += 1  # graph-level input_stream/output_stream value

    # invert the temp "<-src" input records into producer outputs —
    # snapshot all pendings BEFORE inverting, since inversion appends
    # real output records to nodes not yet processed
    by_name = {n.name: n for n in nodes}
    pendings = {n.name: n.outputs for n in nodes}
    for n in nodes:
        n.outputs = []
    for n in nodes:
        for spad, marker, dpad in pendings[n.name]:
            src = marker[2:]
            if src not in by_name:
                raise ValueError(f"pbtxt: unknown stream source {src!r}")
            by_name[src].outputs.append((spad, n.name, dpad))

    # emit: every element as a named segment, then one chain per link
    segs = []
    for n in nodes:
        props = " ".join(f"{k}={_quote_prop(v)}"
                         for k, v in n.props.items())
        segs.append(f"{n.factory} name={n.name}"
                    + (f" {props}" if props else ""))
    links = []
    for n in nodes:
        for spad, peer, dpad in n.outputs:
            src = f"{n.name}.{spad}" if spad else f"{n.name}."
            dst = f"{peer}.{dpad}" if dpad else f"{peer}."
            links.append(f"{src} ! {dst}")
    return "  ".join(segs + links)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"')


def _quote_prop(v: str) -> str:
    # parse_launch tokenizes with posix shlex: backslashes must be
    # escaped even outside quotes or they are consumed on re-parse
    if any(c in v for c in ' !\t"\\'):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    return v


def main() -> int:
    if "--help" in sys.argv[1:] or "-h" in sys.argv[1:]:
        print("usage: nnstreamer-tpu-torch-convert [--from-pbtxt|-p] < input\n"
              "Convert a parse_launch pipeline string (stdin) to pbtxt, "
              "or pbtxt back to a launch string with --from-pbtxt.")
        return 0
    text = sys.stdin.read()
    if not text.strip():
        print("nnstreamer-tpu-torch-convert: empty input (pipe a pipeline "
              "description on stdin; --help for usage)", file=sys.stderr)
        return 2
    if "--from-pbtxt" in sys.argv[1:] or "-p" in sys.argv[1:]:
        print(pbtxt_to_launch(text))
    else:
        print(launch_to_pbtxt(text.strip()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
