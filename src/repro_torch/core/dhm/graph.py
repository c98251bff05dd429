"""Dataflow-process-network IR (paper §4, Figs. 1-2).

A verbatim copy of ``repro.core.dhm.graph`` (pure Python): the port keeps its own
copy so that it imports nothing of the JAX package.

A model is a :class:`DataflowGraph` of :class:`Actor` nodes connected by
unidirectional stream edges. The granularity follows the paper exactly:

- one **conv engine** per (output-map n, input-channel c) pair: K*K
  multipliers + one adder-tree actor + a (K-1)-line line buffer;
- one **neuron sum** actor per output map (sums C engine outputs + bias);
- one **activation** actor per output map;
- one **pool** actor per output map.

For the Fig. 2 example (C=3, N=5, K=3) this yields 15 conv engines
(135 multipliers, 15 adder trees), 5 neuron adders and 5 activations —
matching the paper's count of "135 multiplications, 20 sums and 5
activations".

The same IR carries transformer layer graphs (one actor per layer-block) for
the TPU spatial mapper — there the per-actor payload is FLOPs/bytes rather
than multiplier counts.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Mapping, Sequence


class ActorKind(enum.Enum):
    SOURCE = "source"
    WINDOW = "window"  # (K-1)-line sliding-window buffer, one per input stream
    CONV_ENGINE = "conv_engine"  # K*K multipliers + adder tree
    NEURON_SUM = "neuron_sum"  # sums C conv-engine streams + bias
    ACTIVATION = "activation"
    POOL = "pool"
    DENSE = "dense"
    BLOCK = "block"  # coarse-grain actor (transformer layer etc.)
    SINK = "sink"


@dataclasses.dataclass(frozen=True)
class Actor:
    name: str
    kind: ActorKind
    # Hardware payload (paper granularity):
    multipliers: int = 0  # constant-coefficient multipliers inside
    adders: int = 0  # adder actors inside (tree counted as 1 per engine)
    line_buffer_bits: int = 0  # (K-1) lines x line_width x bits
    # Workload payload (TPU granularity):
    flops: float = 0.0  # per processed frame/token-batch
    param_bytes: float = 0.0
    stream_bytes: float = 0.0  # output stream per frame/token-batch
    layer: int = -1  # topological layer index (stage partitioning)


@dataclasses.dataclass
class DataflowGraph:
    name: str
    actors: list
    edges: list  # (producer_name, consumer_name)

    def actor(self, name: str) -> Actor:
        for a in self.actors:
            if a.name == name:
                return a
        raise KeyError(name)

    def count(self, kind: ActorKind) -> int:
        return sum(1 for a in self.actors if a.kind == kind)

    def total_multipliers(self) -> int:
        return sum(a.multipliers for a in self.actors)

    def total_adders(self) -> int:
        return sum(a.adders for a in self.actors)

    def total_line_buffer_bits(self) -> int:
        return sum(a.line_buffer_bits for a in self.actors)

    def total_flops(self) -> float:
        return sum(a.flops for a in self.actors)

    def layers(self) -> list:
        """Actors grouped by topological layer index."""
        by_layer: dict = {}
        for a in self.actors:
            by_layer.setdefault(a.layer, []).append(a)
        return [by_layer[k] for k in sorted(by_layer)]

    def layer_payloads(self) -> list:
        """Aggregate actor payloads per topological layer: one dict of
        {flops, param_bytes, stream_bytes, stream_bytes_by_kind,
        line_buffer_bits, multipliers} per layer. The benchmarks use this
        to report what cross-layer fusion keeps on-chip: a conv layer's
        *boundary* stream (the frame its terminal pool — or activation,
        when unpooled — actors emit) is exactly the inter-layer traffic
        that no longer crosses external memory once the layer fuses with
        its consumer."""
        by_layer: dict = {}
        for a in self.actors:
            d = by_layer.setdefault(
                a.layer,
                {
                    "flops": 0.0,
                    "param_bytes": 0.0,
                    "stream_bytes": 0.0,
                    "stream_bytes_by_kind": {},
                    "line_buffer_bits": 0,
                    "multipliers": 0,
                },
            )
            d["flops"] += a.flops
            d["param_bytes"] += a.param_bytes
            d["stream_bytes"] += a.stream_bytes
            by_kind = d["stream_bytes_by_kind"]
            by_kind[a.kind.value] = by_kind.get(a.kind.value, 0.0) + a.stream_bytes
            d["line_buffer_bits"] += a.line_buffer_bits
            d["multipliers"] += a.multipliers
        return [by_layer[k] for k in sorted(by_layer)]

    def boundary_stream_bytes(self, layer: int) -> float:
        """Bytes/frame of the named topological layer's output stream —
        the pool actors' streams when the layer pools, else the
        activation actors' (the frame handed to the next layer)."""
        by_kind = self.layer_payloads()[layer]["stream_bytes_by_kind"]
        if ActorKind.POOL.value in by_kind:
            return by_kind[ActorKind.POOL.value]
        return by_kind.get(ActorKind.ACTIVATION.value, 0.0)

    def validate(self) -> None:
        names = {a.name for a in self.actors}
        if len(names) != len(self.actors):
            raise ValueError(f"duplicate actor names in {self.name}")
        for p, c in self.edges:
            if p not in names or c not in names:
                raise ValueError(f"edge ({p},{c}) references unknown actor")


def cnn_to_dpn(topo, *, bits: int) -> DataflowGraph:
    """Expand a CNN topology into the paper's actor graph (Figs. 1-2).

    ``bits`` is the fixed-point width: it sizes line buffers and stream
    widths. Only the feature extractor is expanded (the paper maps the
    feature extractor; Table 4 footnote).
    """
    actors: list = [Actor(name="input", kind=ActorKind.SOURCE, layer=0)]
    edges: list = []
    prev_outputs = ["input"]
    layer_idx = 0
    h_in, w_in = topo.input_shape
    for li, (c_in, n_out, k, h_out, w_out) in enumerate(topo.conv_shapes()):
        spec = topo.conv_layers[li]
        layer_idx += 1
        acc_bits = 2 * bits + _ceil_log2(k * k * max(1, c_in))
        # The sliding-window buffer holds (K-1) *input* lines: with SAME
        # stride-1 convs (the paper nets) the input and conv-output widths
        # coincide, but strided/VALID layers must buffer the wider input
        # frame, not the conv output.
        line_w = w_in
        # One sliding-window line buffer per *input stream*, shared by all N
        # engines that read it ([10]; this is why the paper's memory
        # footprint stays tiny).
        window_names = []
        for c in range(c_in):
            wname = f"win{li + 1}_c{c}"
            actors.append(
                Actor(
                    name=wname,
                    kind=ActorKind.WINDOW,
                    line_buffer_bits=(k - 1) * line_w * bits,
                    stream_bytes=h_out * w_out * bits / 8.0,
                    layer=layer_idx,
                )
            )
            edges.append((prev_outputs[c % len(prev_outputs)], wname))
            window_names.append(wname)
        neuron_names = []
        for n in range(n_out):
            engine_outs = []
            for c in range(c_in):
                name = f"conv{li + 1}_n{n}_c{c}"
                actors.append(
                    Actor(
                        name=name,
                        kind=ActorKind.CONV_ENGINE,
                        multipliers=k * k,
                        adders=1,  # the engine's adder tree, paper-counted as 1
                        flops=2.0 * k * k * h_out * w_out,
                        param_bytes=k * k * bits / 8.0,
                        stream_bytes=h_out * w_out * acc_bits / 8.0,
                        layer=layer_idx,
                    )
                )
                edges.append((window_names[c], name))
                engine_outs.append(name)
            sum_name = f"sum{li + 1}_n{n}"
            actors.append(
                Actor(
                    name=sum_name,
                    kind=ActorKind.NEURON_SUM,
                    adders=1,
                    flops=2.0 * c_in * h_out * w_out,
                    stream_bytes=h_out * w_out * acc_bits / 8.0,
                    layer=layer_idx,
                )
            )
            for e in engine_outs:
                edges.append((e, sum_name))
            act_name = f"act{li + 1}_n{n}"
            actors.append(
                Actor(
                    name=act_name,
                    kind=ActorKind.ACTIVATION,
                    flops=1.0 * h_out * w_out,
                    stream_bytes=h_out * w_out * bits / 8.0,
                    layer=layer_idx,
                )
            )
            edges.append((sum_name, act_name))
            out_name = act_name
            pw, ps = spec.pool_cfg
            if pw:
                pool_name = f"pool{li + 1}_n{n}"
                # VALID sliding-window output dims: window pw, stride ps
                # (NOT h_out // window — that silently mis-shapes every
                # overlapping pool). The streaming pool buffers (pw - 1)
                # conv-output lines regardless of stride.
                h_p = (h_out - pw) // ps + 1
                w_p = (w_out - pw) // ps + 1
                actors.append(
                    Actor(
                        name=pool_name,
                        kind=ActorKind.POOL,
                        flops=1.0 * pw * pw * h_p * w_p,
                        line_buffer_bits=(pw - 1) * w_out * bits,
                        stream_bytes=h_p * w_p * bits / 8.0,
                        layer=layer_idx,
                    )
                )
                edges.append((act_name, pool_name))
                out_name = pool_name
            neuron_names.append(out_name)
        prev_outputs = neuron_names
        h_in, w_in = spec.out_hw(h_in, w_in)
    actors.append(
        Actor(name="output", kind=ActorKind.SINK, layer=layer_idx + 1)
    )
    for p in prev_outputs:
        edges.append((p, "output"))
    g = DataflowGraph(name=topo.name, actors=actors, edges=edges)
    g.validate()
    return g


def layer_costs_to_dpn(
    name: str, layer_costs: Sequence[Mapping[str, float]]
) -> DataflowGraph:
    """Coarse-grain DPN for the TPU spatial mapper: one BLOCK actor per
    layer, payloads = {'flops', 'param_bytes', 'stream_bytes'}."""
    actors = [Actor(name="input", kind=ActorKind.SOURCE, layer=0)]
    edges = []
    prev = "input"
    for i, cost in enumerate(layer_costs):
        nm = f"layer{i}"
        actors.append(
            Actor(
                name=nm,
                kind=ActorKind.BLOCK,
                flops=float(cost.get("flops", 0.0)),
                param_bytes=float(cost.get("param_bytes", 0.0)),
                stream_bytes=float(cost.get("stream_bytes", 0.0)),
                layer=i + 1,
            )
        )
        edges.append((prev, nm))
        prev = nm
    actors.append(Actor(name="output", kind=ActorKind.SINK, layer=len(layer_costs) + 1))
    edges.append((prev, "output"))
    g = DataflowGraph(name=name, actors=actors, edges=edges)
    g.validate()
    return g


def _ceil_log2(x: int) -> int:
    n = 0
    v = 1
    while v < x:
        v *= 2
        n += 1
    return n
