"""ComputationGraph configuration: a DAG of layers and vertices
(counterpart of `deeplearning4j_tpu/nn/conf/computation_graph_configuration.py`).

`GraphBuilder.build()` does what the JAX package's does: it merges the
global hyperparameters into every layer, sorts the nodes topologically
(Kahn's algorithm over the sorted ready set, refusing a cycle),
propagates the input types through the DAG, infers each layer's `n_in`
and inserts the preprocessor a change of layer kind needs. `to_json`
writes the JAX package's format ("deeplearning4j_tpu/
ComputationGraphConfiguration/v1") field for field, so a graph's JSON
round-trips between the two packages.

The vertices are plain functions of their input tensors; autograd gives
their backward. Layouts are the JAX package's: a merge concatenates on
the last axis (NHWC channels), a stack on the batch axis.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType,
    InputTypeConvolutional,
    InputTypeConvolutionalFlat,
    InputTypeFeedForward,
    InputTypeRecurrent,
)
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ConvolutionLayer,
    FeedForwardLayer,
    Layer,
    layer_from_json,
    layer_to_json,
)
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    GlobalConf,
    MultiLayerConfiguration,
    _auto_preprocessor,
    _merge_layer_defaults,
    _warn_loss_activation_mismatch,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    InputPreProcessor,
    preprocessor_from_json,
    preprocessor_to_json,
)

# ---------------------------------------------------------------------------
# graph vertices: forward-only functions of their inputs

_VERTEX_REGISTRY: Dict[str, type] = {}


def register_vertex(cls):
    _VERTEX_REGISTRY[cls.TYPE] = cls
    return cls


class GraphVertex:
    """A DAG node that is not a layer: a function of one or more input
    activations, with no parameters."""

    def output_type(self, inputs: Sequence[InputType]) -> InputType:
        raise NotImplementedError

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def to_json(self) -> dict:
        return {"type": self.TYPE, **dataclasses.asdict(self)}

    @staticmethod
    def from_json(d: dict) -> "GraphVertex":
        d = dict(d)
        return _VERTEX_REGISTRY[d.pop("type")](**d)


@register_vertex
@dataclass
class MergeVertex(GraphVertex):
    """Concatenation on the feature (last) axis: NHWC channels."""

    TYPE = "merge"

    def output_type(self, inputs):
        it0 = inputs[0]
        if isinstance(it0, InputTypeFeedForward):
            return InputType.feed_forward(sum(i.size for i in inputs))
        if isinstance(it0, InputTypeRecurrent):
            return InputType.recurrent(sum(i.size for i in inputs),
                                       it0.timeseries_length)
        if isinstance(it0, InputTypeConvolutional):
            return InputType.convolutional(it0.height, it0.width,
                                           sum(i.channels for i in inputs))
        raise ValueError(f"merge: unsupported {it0}")

    def forward(self, inputs):
        return torch.cat(list(inputs), dim=-1)


class ElementWiseOp(str, enum.Enum):
    ADD = "add"
    SUBTRACT = "subtract"
    PRODUCT = "product"
    AVERAGE = "average"
    MAX = "max"


@register_vertex
@dataclass
class ElementWiseVertex(GraphVertex):
    """Element-wise combination of equal-shaped inputs (ADD is the
    residual connection)."""

    TYPE = "elementwise"
    op: ElementWiseOp = ElementWiseOp.ADD

    def output_type(self, inputs):
        return inputs[0]

    def forward(self, inputs):
        op = ElementWiseOp(self.op)
        out = inputs[0]
        if op == ElementWiseOp.ADD:
            for x in inputs[1:]:
                out = out + x
            return out
        if op == ElementWiseOp.SUBTRACT:
            if len(inputs) != 2:
                raise ValueError(f"subtract takes 2 inputs, got "
                                 f"{len(inputs)}")
            return inputs[0] - inputs[1]
        if op == ElementWiseOp.PRODUCT:
            for x in inputs[1:]:
                out = out * x
            return out
        if op == ElementWiseOp.AVERAGE:
            for x in inputs[1:]:
                out = out + x
            return out / len(inputs)
        if op == ElementWiseOp.MAX:
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        raise ValueError(op)


@register_vertex
@dataclass
class SubsetVertex(GraphVertex):
    """The feature range [from_idx, to_idx], both included."""

    TYPE = "subset"
    from_idx: int = 0
    to_idx: int = 0

    def output_type(self, inputs):
        n = self.to_idx - self.from_idx + 1
        it = inputs[0]
        if isinstance(it, InputTypeRecurrent):
            return InputType.recurrent(n, it.timeseries_length)
        return InputType.feed_forward(n)

    def forward(self, inputs):
        return inputs[0][..., self.from_idx:self.to_idx + 1]


@register_vertex
@dataclass
class StackVertex(GraphVertex):
    """The inputs' minibatches stacked along the batch axis."""

    TYPE = "stack"

    def output_type(self, inputs):
        return inputs[0]

    def forward(self, inputs):
        return torch.cat(list(inputs), dim=0)


@register_vertex
@dataclass
class UnstackVertex(GraphVertex):
    """Slice `index` of `num_stacks` equal slices of the batch axis."""

    TYPE = "unstack"
    index: int = 0
    num_stacks: int = 1

    def output_type(self, inputs):
        return inputs[0]

    def forward(self, inputs):
        x = inputs[0]
        size = x.shape[0] // self.num_stacks
        return x[self.index * size:(self.index + 1) * size]


@register_vertex
@dataclass
class L2NormalizeVertex(GraphVertex):
    """Each row divided by its L2 norm (plus eps)."""

    TYPE = "l2_normalize"
    eps: float = 1e-8

    def output_type(self, inputs):
        return inputs[0]

    def forward(self, inputs):
        x = inputs[0]
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True)
                    + self.eps)


@register_vertex
@dataclass
class L2Vertex(GraphVertex):
    """The L2 distance between two inputs, row by row: (B, 1)."""

    TYPE = "l2"
    eps: float = 1e-8

    def output_type(self, inputs):
        return InputType.feed_forward(1)

    def forward(self, inputs):
        a, b = inputs
        return torch.sqrt(torch.sum((a - b) ** 2, dim=-1, keepdim=True)
                          + self.eps)


@register_vertex
@dataclass
class ScaleVertex(GraphVertex):
    """The input times a fixed scalar."""

    TYPE = "scale"
    scale: float = 1.0

    def output_type(self, inputs):
        return inputs[0]

    def forward(self, inputs):
        return inputs[0] * self.scale


@register_vertex
@dataclass
class ShiftVertex(GraphVertex):
    """The input plus a fixed scalar."""

    TYPE = "shift"
    shift: float = 0.0

    def output_type(self, inputs):
        return inputs[0]

    def forward(self, inputs):
        return inputs[0] + self.shift


@register_vertex
@dataclass
class LastTimeStepVertex(GraphVertex):
    """(B, T, F) -> (B, F) at each row's last unmasked step: the network
    passes the mask of `mask_input` (or of the vertex's input); without
    one, the last step."""

    TYPE = "last_time_step"
    mask_input: Optional[str] = None

    def output_type(self, inputs):
        it = inputs[0]
        if not isinstance(it, InputTypeRecurrent):
            raise ValueError(f"last_time_step needs a recurrent input, "
                             f"got {it}")
        return InputType.feed_forward(it.size)

    def forward(self, inputs, mask=None):
        x = inputs[0]
        if mask is None:
            return x[:, -1]
        idx = torch.clamp(mask.sum(dim=1).to(torch.int64) - 1, min=0)
        return x[torch.arange(x.shape[0], device=x.device), idx]


@register_vertex
@dataclass
class DuplicateToTimeSeriesVertex(GraphVertex):
    """(B, F) -> (B, T, F), broadcast over the time axis of the network
    input `reference_input` (or over `length` steps)."""

    TYPE = "duplicate_to_time_series"
    reference_input: str = ""
    length: int = -1

    def output_type(self, inputs):
        return InputType.recurrent(inputs[0].size, self.length)

    def forward(self, inputs, length: Optional[int] = None):
        x = inputs[0]
        t = length if length is not None else self.length
        return x[:, None, :].expand(x.shape[0], t, x.shape[1])


@register_vertex
@dataclass
class PreprocessorVertex(GraphVertex):
    """An input preprocessor as a vertex of its own."""

    TYPE = "preprocessor"
    preprocessor: Optional[InputPreProcessor] = None

    def output_type(self, inputs):
        return self.preprocessor.output_type(inputs[0])

    def forward(self, inputs, rng=None, train=False):
        return self.preprocessor.preprocess(inputs[0], rng=rng, train=train)

    def to_json(self) -> dict:
        return {"type": self.TYPE,
                "preprocessor": preprocessor_to_json(self.preprocessor)}


def _vertex_from_json(d: dict) -> GraphVertex:
    if d.get("type") == PreprocessorVertex.TYPE:
        return PreprocessorVertex(preprocessor_from_json(d["preprocessor"]))
    return GraphVertex.from_json(d)


# ---------------------------------------------------------------------------
# node + configuration


@dataclass
class GraphNode:
    """One DAG node: a layer (with the preprocessor that runs before it,
    if any) or a GraphVertex, and the names of its inputs."""

    name: str
    inputs: List[str]
    layer: Optional[Layer] = None
    vertex: Optional[GraphVertex] = None
    preprocessor: Optional[InputPreProcessor] = None

    @property
    def is_layer(self) -> bool:
        return self.layer is not None


@dataclass
class ComputationGraphConfiguration:
    """A built DAG configuration; `topological_order` is the order the
    network runs its nodes in."""

    network_inputs: List[str]
    network_outputs: List[str]
    nodes: Dict[str, GraphNode]
    topological_order: List[str]
    global_conf: GlobalConf = field(default_factory=GlobalConf)
    input_types: Optional[List[InputType]] = None
    resolved_types: Dict[str, InputType] = field(default_factory=dict)
    backprop: bool = True
    pretrain: bool = False
    tbptt_fwd_length: int = -1
    tbptt_bwd_length: int = -1

    @property
    def seed(self) -> int:
        return self.global_conf.seed

    def to_json(self) -> str:
        g = dataclasses.asdict(self.global_conf)
        for k, v in list(g.items()):
            if isinstance(v, enum.Enum):
                g[k] = v.value
        if self.global_conf.dist is not None:
            g["dist"] = self.global_conf.dist.to_json()
        nodes = {}
        for name, n in self.nodes.items():
            nodes[name] = {
                "inputs": n.inputs,
                "layer": layer_to_json(n.layer) if n.layer else None,
                "vertex": n.vertex.to_json() if n.vertex else None,
                "preprocessor": preprocessor_to_json(n.preprocessor)
                if n.preprocessor else None,
            }
        return json.dumps({
            "format": "deeplearning4j_tpu/ComputationGraphConfiguration/v1",
            "global_conf": g,
            "network_inputs": self.network_inputs,
            "network_outputs": self.network_outputs,
            "topological_order": self.topological_order,
            "nodes": nodes,
            "input_types": [t.to_json() for t in self.input_types]
            if self.input_types else None,
            "backprop": self.backprop,
            "pretrain": self.pretrain,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_bwd_length": self.tbptt_bwd_length,
        }, indent=2)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        d = json.loads(s)
        g = MultiLayerConfiguration.from_json(json.dumps(
            {"global_conf": d.get("global_conf", {}),
             "layers": []})).global_conf
        nodes = {}
        for name, nd in d["nodes"].items():
            nodes[name] = GraphNode(
                name=name,
                inputs=list(nd["inputs"]),
                layer=layer_from_json(nd["layer"])
                if nd.get("layer") else None,
                vertex=_vertex_from_json(nd["vertex"])
                if nd.get("vertex") else None,
                preprocessor=preprocessor_from_json(nd["preprocessor"])
                if nd.get("preprocessor") else None)
        conf = ComputationGraphConfiguration(
            network_inputs=list(d["network_inputs"]),
            network_outputs=list(d["network_outputs"]),
            nodes=nodes,
            topological_order=list(d["topological_order"]),
            global_conf=g,
            input_types=[InputType.from_json(t) for t in d["input_types"]]
            if d.get("input_types") else None,
            backprop=d.get("backprop", True),
            pretrain=d.get("pretrain", False),
            tbptt_fwd_length=d.get("tbptt_fwd_length", -1),
            tbptt_bwd_length=d.get("tbptt_bwd_length", -1))
        conf._resolve_types()
        return conf

    def _resolve_types(self):
        """Every node's output type through the DAG (n_in and the
        automatic preprocessors come from `GraphBuilder.build`; this
        recomputes the types, for example after `from_json`)."""
        if self.input_types is None:
            return
        types: Dict[str, InputType] = dict(zip(self.network_inputs,
                                               self.input_types))
        for name in self.topological_order:
            if name in types:
                continue
            node = self.nodes[name]
            in_types = [types[i] for i in node.inputs]
            if node.is_layer:
                it = in_types[0]
                if node.preprocessor is not None:
                    it = node.preprocessor.output_type(it)
                types[name] = node.layer.output_type(it)
            else:
                types[name] = node.vertex.output_type(in_types)
        self.resolved_types = types


class GraphBuilder:
    """The fluent DAG builder, reached by
    `NeuralNetConfiguration.Builder().graph_builder()`."""

    def __init__(self, global_conf: GlobalConf):
        self._g = global_conf
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._nodes: Dict[str, GraphNode] = {}
        self._input_types: Optional[List[InputType]] = None
        self._backprop = True
        self._pretrain = False
        self._tbptt_fwd = -1
        self._tbptt_bwd = -1

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def _add(self, name: str, node: GraphNode) -> "GraphBuilder":
        if name in self._nodes or name in self._inputs:
            raise ValueError(f"duplicate vertex name {name!r}")
        self._nodes[name] = node
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str
                  ) -> "GraphBuilder":
        return self._add(name, GraphNode(name, list(inputs), layer=layer))

    def add_vertex(self, name: str, vertex: GraphVertex, *inputs: str
                   ) -> "GraphBuilder":
        return self._add(name, GraphNode(name, list(inputs), vertex=vertex))

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        self._input_types = list(types)
        return self

    def backprop(self, b: bool) -> "GraphBuilder":
        self._backprop = b
        return self

    def pretrain(self, p: bool) -> "GraphBuilder":
        self._pretrain = p
        return self

    def t_bptt_forward_length(self, n: int) -> "GraphBuilder":
        self._tbptt_fwd = n
        return self

    def t_bptt_backward_length(self, n: int) -> "GraphBuilder":
        self._tbptt_bwd = n
        return self

    def build(self) -> ComputationGraphConfiguration:
        if not self._inputs:
            raise ValueError("graph has no inputs (addInputs)")
        if not self._outputs:
            raise ValueError("graph has no outputs (setOutputs)")
        for name, node in self._nodes.items():
            for i in node.inputs:
                if i not in self._nodes and i not in self._inputs:
                    raise ValueError(f"vertex {name!r} references unknown "
                                     f"input {i!r}")
        for o in self._outputs:
            if o not in self._nodes:
                raise ValueError(f"output {o!r} is not a vertex")
        topo = self._topological_sort()
        for name, node in self._nodes.items():
            if node.is_layer:
                node.layer = _merge_layer_defaults(node.layer, self._g)
                _warn_loss_activation_mismatch(node.layer, name)
        conf = ComputationGraphConfiguration(
            network_inputs=list(self._inputs),
            network_outputs=list(self._outputs),
            nodes=self._nodes,
            topological_order=topo,
            global_conf=self._g,
            input_types=self._input_types,
            backprop=self._backprop,
            pretrain=self._pretrain,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_bwd_length=self._tbptt_bwd)
        if self._input_types is not None:
            self._infer(conf)
        conf._resolve_types()
        return conf

    def _topological_sort(self) -> List[str]:
        """Kahn's algorithm over the sorted ready set; raises on a
        cycle."""
        indeg = {n: 0 for n in self._nodes}
        dependents: Dict[str, List[str]] = {n: [] for n in self._nodes}
        for name, node in self._nodes.items():
            for i in node.inputs:
                if i in self._nodes:
                    indeg[name] += 1
                    dependents[i].append(name)
        ready = sorted(n for n, d in indeg.items() if d == 0)
        order: List[str] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for dep in dependents[n]:
                indeg[dep] -= 1
                if indeg[dep] == 0:
                    ready.append(dep)
        if len(order) != len(self._nodes):
            cyclic = [n for n, d in indeg.items() if d > 0]
            raise ValueError(f"graph contains a cycle involving {cyclic}")
        return order

    @staticmethod
    def _infer(conf: ComputationGraphConfiguration):
        """n_in inference and automatic preprocessors through the DAG."""
        types: Dict[str, InputType] = dict(zip(conf.network_inputs,
                                               conf.input_types))
        for name in conf.topological_order:
            node = conf.nodes[name]
            in_types = [types[i] for i in node.inputs]
            if not node.is_layer:
                types[name] = node.vertex.output_type(in_types)
                continue
            it = in_types[0]
            if node.preprocessor is None:
                node.preprocessor = _auto_preprocessor(node.layer, it)
            if node.preprocessor is not None:
                it = node.preprocessor.output_type(it)
            layer = node.layer
            if isinstance(layer, FeedForwardLayer) \
                    and getattr(layer, "n_in", 0) in (0, None):
                if isinstance(it, (InputTypeFeedForward, InputTypeRecurrent)):
                    layer.n_in = it.size
                elif isinstance(it, InputTypeConvolutional):
                    layer.n_in = it.channels \
                        if isinstance(layer, ConvolutionLayer) \
                        else it.height * it.width * it.channels
                elif isinstance(it, InputTypeConvolutionalFlat):
                    layer.n_in = it.flattened_size
            types[name] = layer.output_type(it)
