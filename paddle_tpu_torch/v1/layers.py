"""v1 layer API (reference python/paddle/trainer_config_helpers/layers.py,
7531 LoC / 72 ``*_layer`` functions mapping onto gserver Layer classes,
SURVEY.md §2.13).

The port of ``paddle_tpu/v1/layers.py``: every function builds the same
desc as the JAX package's.  Instead of emitting a `ModelConfig` protobuf
interpreted by a C++ trainer, every v1 function builds the same Program IR
the fluid layer API builds, which the executor runs op by op.  A layer
whose op type the port's registry lacks builds its desc and raises the
registry's ``KeyError`` at its first run.  `LayerOutput` carries
the fluid Variable plus the v1 metadata (size, activation) so v1 configs
compose exactly as in the reference; `parse_network` returns the Program the
way config_parser.parse_config returned the proto."""

from __future__ import annotations

from typing import Optional, Sequence, Union

from .. import layers as fl
from ..framework.core import Program, Variable, default_main_program
from ..framework.layer_helper import LayerHelper
from ..layers.sequence import get_length_var as _get_length_strict
from ..layers.sequence import propagate_length


def get_length_var(var):
    """Non-raising probe: the v1 API dispatches dense-vs-sequence on this."""
    if getattr(var, "_length_var_name", None) is None:
        return None
    return _get_length_strict(var)
from .activations import BaseActivation, LinearActivation, TanhActivation, \
    SigmoidActivation, SoftmaxActivation, act_name
from .attrs import to_param_attr
from .poolings import AvgPooling, MaxPooling, pool_name


class LayerOutput:
    """v1 handle (layers.py LayerOutput): wraps the fluid Variable."""

    def __init__(self, var: Variable, layer_type: str, size: Optional[int] = None,
                 parents: Sequence["LayerOutput"] = (), act: Optional[str] = None):
        self.var = var
        self.name = var.name
        self.layer_type = layer_type
        self.size = size
        self.parents = list(parents)
        self.act = act  # applied activation op name (v1 active_type)
        # named auxiliary outputs for get_output_layer (reference layers
        # returning multiple Arguments, e.g. lstm_step's 'state')
        self.outputs = {}

    def __repr__(self):
        return f"LayerOutput({self.name!r}, type={self.layer_type}, size={self.size})"


def _var(x) -> Variable:
    if isinstance(x, MixedLayerType):  # finalized `with` form
        x = x._out
    return x.var if isinstance(x, LayerOutput) else x


def _vars(xs):
    return [_var(x) for x in (xs if isinstance(xs, (list, tuple)) else [xs])]


def _wrap(var, layer_type, size=None, parents=(), act=None, name=None):
    if name is not None:
        _register_name(name, var)
    return LayerOutput(var, layer_type, size=size, parents=parents, act=act)


# --- recurrent group context (reference layers.py recurrent_group:4082,
# memory:3590; RecurrentGradientMachine semantics) ---------------------------

_rgroup = None  # the active _RecurrentGroupCtx during step-function tracing


class _RecurrentGroupCtx:
    def __init__(self, rnn, batch_ref):
        self.rnn = rnn
        self.batch_ref = batch_ref
        self.pending = {}  # layer name a memory remembers -> inner mem var

    def make_memory(self, key, init, size):
        return self.rnn.memory(init=init, shape=[int(size)],
                               batch_ref=self.batch_ref)

    def bind(self, name, var):
        self.rnn.update_memory(self.pending.pop(name), var)


def _expand_lanes(block, v, K, trailing):
    """Beam-lane broadcast [B, *trailing] -> [B*K, *trailing] via the
    beam_expand op, appended to an EXPLICIT block — beam_search uses it
    both for its pre-loop StaticInputs (current block) and for memory boot
    values, whose carried var must live in the block OUTSIDE the while.
    `trailing` may contain dynamic (-1) dims, e.g. padded sequence T."""
    from ..framework import unique_name

    shape = tuple([-1] + [int(d) for d in trailing])
    out = block.create_var(name=unique_name.generate("beam_exp"),
                           shape=shape, dtype=v.dtype, stop_gradient=True)
    block.append_op("beam_expand", inputs={"X": [v.name]},
                    outputs={"Out": [out.name]},
                    attrs={"beam_size": int(K)})
    return out


class _BeamGroupCtx:
    """recurrent-group context in GENERATION mode (beam_search below):
    memories become While-carried flat [B*K, size] vars created in the
    OUTER block, re-gathered by beam parent pointers after every step
    (the RecurrentGradientMachine.h:309 per-hypothesis state, as static
    beam lanes)."""

    def __init__(self, outer_block, flat_ref_name, beam_size):
        self.outer = outer_block
        self.flat_ref = flat_ref_name  # [B*K, 1] anchor var in outer block
        self.K = int(beam_size)
        self.pending = {}
        self.mems = []   # (key, carried outer var, size)
        self.bound = {}  # key -> this step's new value var (sub-block)

    def make_memory(self, key, init, size):
        if init is None:
            from ..framework import unique_name
            mem = self.outer.create_var(
                name=unique_name.generate("beam_mem"),
                shape=(-1, int(size)), dtype="float32", stop_gradient=True)
            self.outer.append_op(
                "fill_constant_batch_size_like",
                inputs={"Input": [self.flat_ref]},
                outputs={"Out": [mem.name]},
                attrs={"shape": [-1, int(size)], "value": 0.0,
                       "dtype": "float32", "input_dim_idx": 0,
                       "output_dim_idx": 0})
        else:
            # boot [B, size] -> [B*K, size] in the OUTER block
            mem = _expand_lanes(self.outer, init, self.K, [int(size)])
        self.mems.append((key, mem, int(size)))
        return mem

    def bind(self, name, var):
        self.pending.pop(name, None)
        self.bound[name] = var


def _register_name(name, var):
    """v1 memories bind by layer NAME: `memory(name='s')` remembers the
    output of whichever layer is later built with name='s' (reference
    config_parser Memory linkage).  Every wrapper that accepts name= routes
    through here so building that layer closes the recurrence."""
    if _rgroup is not None and name in _rgroup.pending:
        _rgroup.bind(name, var)


def _apply_act(var, act):
    a = act_name(act)
    if not a:
        return var
    helper = LayerHelper("activation", act=a)
    return helper.append_activation(var)


# --- v1 constants / decorators (reference layers.py:  AggregateLevel:138,
# ExpandLevel:  ~1520, LayerType:208, layer_support:313) ---------------------

class AggregateLevel:
    """Sequence-aggregation level for pooling/concat layers."""
    TO_NO_SEQUENCE = "non-seq"
    TO_SEQUENCE = "seq"
    # deprecated reference spellings kept for config compatibility
    EACH_TIMESTEP = TO_NO_SEQUENCE
    EACH_SEQUENCE = TO_SEQUENCE


class ExpandLevel:
    """Expansion level for expand_layer."""
    FROM_NO_SEQUENCE = AggregateLevel.TO_NO_SEQUENCE
    FROM_SEQUENCE = AggregateLevel.TO_SEQUENCE
    FROM_TIMESTEP = FROM_NO_SEQUENCE


class LayerType:
    """Layer-type name constants (reference layers.py LayerType:208).  The
    reference validates each name against config_parser; here the names
    document the v1 surface and `is_layer_type` keeps the API contract."""
    DATA = "data"
    FC_LAYER = "fc"
    CONV_LAYER = "conv"
    CONVTRANS_LAYER = "convt"
    POOL_LAYER = "pool"
    BATCH_NORM_LAYER = "batch_norm"
    LSTMEMORY = "lstmemory"
    GRUMEMORY = "gated_recurrent"
    RECURRENT_LAYER_GROUP = "recurrent_layer_group"
    SEQUENCE_LAST_INSTANCE = "last_seq"
    SEQUENCE_FIRST_INSTANCE = "first_seq"
    POOLING_MAX = "max"
    POOLING_AVG = "average"
    CONCAT_LAYER = "concat"
    MIXED_LAYER = "mixed"
    COST = "cost"
    CTC_LAYER = "ctc"
    CRF_LAYER = "crf"
    MAXID_LAYER = "max_id"
    EOSID_LAYER = "eos_id"
    MEMORY = "memory"

    @staticmethod
    def is_layer_type(type_name):
        return isinstance(type_name, str) and bool(type_name)


def layer_support(*attrs):
    """Decorator marking which ExtraLayerAttribute features a layer supports
    (reference layers.py layer_support:313).  Device placement/dropout
    attrs are Program-level concerns here, so this only preserves the
    decoration contract."""
    def decorator(fn):
        return fn
    if len(attrs) == 1 and callable(attrs[0]):
        return attrs[0]
    return decorator


# --- data --------------------------------------------------------------------

def data_layer(name, size, depth=None, height=None, width=None,
               dtype="float32", seq=False):
    """DataLayer (layers.py data_layer).  v1 infers density/sequence-ness
    from the DataProvider; here `seq=True` declares a ragged input with a
    companion length vector, and (height,width) spatial inputs become CHW."""
    if seq:
        shape = [size] if dtype != "int64" else [1]
        v = fl.sequence_data(name, shape=shape, dtype=dtype)
    elif height and width:
        channels = size // (height * width)
        v = fl.data(name, shape=[channels, height, width], dtype=dtype)
    else:
        v = fl.data(name, shape=[size] if dtype != "int64" else [1],
                    dtype=dtype)
    return _wrap(v, "data", size=size)


# --- dense / embedding -------------------------------------------------------

def fc_layer(input, size, act=None, param_attr=None, bias_attr=None,
             layer_attr=None, name=None):
    """FcLayer (layers.py fc_layer; gserver/layers/FullyConnectedLayer)."""
    ins = input if isinstance(input, (list, tuple)) else [input]
    seq = any(get_length_var(_var(i)) is not None for i in ins)
    fn = fl.sequence_fc if seq else fl.fc
    outs = None
    if seq:
        out = None
        for i in ins:  # sequence_fc takes one input; sum multi-input
            o = fl.sequence_fc(_var(i), size=size,
                               param_attr=to_param_attr(param_attr))
            out = o if out is None else fl.elementwise_add(out, o)
        out = _apply_act(out, act)
    else:
        out = fl.fc([_var(i) for i in ins], size=size,
                    act=act_name(act), param_attr=to_param_attr(param_attr),
                    bias_attr=bias_attr)
    return _wrap(out, "fc", size=size, parents=ins, act=act_name(act),
                 name=name)


def embedding_layer(input, size, param_attr=None):
    """table_projection/embedding (layers.py embedding_layer)."""
    iv = _var(input)
    vocab = input.size if isinstance(input, LayerOutput) else None
    if vocab is None:
        raise ValueError("embedding_layer needs a data_layer input with size")
    if get_length_var(iv) is not None:
        out = fl.sequence_embedding(iv, size=[vocab, size],
                                    param_attr=to_param_attr(param_attr))
    else:
        out = fl.embedding(iv, size=[vocab, size],
                           param_attr=to_param_attr(param_attr))
    return _wrap(out, "embedding", size=size, parents=[input])


# --- convolution stack -------------------------------------------------------

def img_conv_layer(input, filter_size, num_filters, num_channels=None,
                   stride=1, padding=0, groups=1, act=None, param_attr=None,
                   bias_attr=None, shared_biases=True, name=None,
                   layer_attr=None, trans=False, layer_type=None):
    """ExpandConvLayer (layers.py img_conv_layer); trans=True (or
    layer_type='exconvt'/'cudnn_convt') = ConvTransLayer (img_trans_layers
    configs)."""
    if trans or layer_type in ("exconvt", "cudnn_convt"):
        helper = LayerHelper("conv2d_transpose",
                             param_attr=to_param_attr(param_attr))
        iv = _var(input)
        C = int(iv.shape[1]) if num_channels is None else int(num_channels)
        ks = ([int(filter_size)] * 2 if not isinstance(filter_size,
                                                       (list, tuple))
              else [int(k) for k in filter_size])
        w = helper.create_parameter(attr=to_param_attr(param_attr) or {},
                                    shape=[C, num_filters] + ks,
                                    dtype=iv.dtype)
        out = helper.create_tmp_variable(iv.dtype, shape=None)
        helper.append_op(
            "conv2d_transpose",
            inputs={"Input": [iv.name], "Filter": [w.name]},
            outputs={"Output": [out.name]},
            attrs={"strides": [int(stride)] * 2,
                   "paddings": [int(padding)] * 2})
        if bias_attr is not False:
            b = helper.create_parameter(attr=to_param_attr(bias_attr) or {},
                                        shape=[num_filters], dtype=iv.dtype,
                                        is_bias=True)
            out = fl.elementwise_add(out, fl.reshape(b, [1, num_filters,
                                                         1, 1]))
        out = _apply_act(out, act)
        return _wrap(out, "convt", size=num_filters, parents=[input],
                     name=name)
    out = fl.conv2d(_var(input), num_filters=num_filters,
                    filter_size=filter_size, stride=stride, padding=padding,
                    groups=groups, act=act_name(act),
                    param_attr=to_param_attr(param_attr), bias_attr=bias_attr)
    return _wrap(out, "conv", size=num_filters, parents=[input], name=name)


def img_pool_layer(input, pool_size, stride=None, pool_type=None, padding=0,
                   name=None, layer_attr=None):
    """PoolLayer (layers.py img_pool_layer)."""
    pt = pool_name(pool_type or MaxPooling)
    pt = {"sum": "average", "sqrt": "average"}.get(pt, pt)  # img pools: max/avg
    out = fl.pool2d(_var(input), pool_size=pool_size,
                    pool_type="avg" if pt == "average" else pt,
                    pool_stride=stride or pool_size, pool_padding=padding)
    return _wrap(out, "pool", size=getattr(input, "size", None),
                 parents=[input])


def img_cmrnorm_layer(input, size=5, scale=0.0128, power=0.75, name=None):
    """CMRProjectionNormLayer — cross-map response norm, i.e. LRN
    (layers.py img_cmrnorm_layer)."""
    helper = LayerHelper("lrn")
    iv = _var(input)
    out = helper.create_tmp_variable(iv.dtype, shape=iv.shape)
    mid = helper.create_tmp_variable(iv.dtype, shape=iv.shape)
    helper.append_op("lrn", inputs={"X": [iv.name]},
                     outputs={"Out": [out.name], "MidOut": [mid.name]},
                     attrs={"n": int(size), "alpha": float(scale),
                            "beta": float(power), "k": 1.0})
    return _wrap(out, "norm", size=getattr(input, "size", None),
                 parents=[input])


def batch_norm_layer(input, act=None, bias_attr=None, param_attr=None,
                     use_global_stats=None, moving_average_fraction=0.9,
                     name=None):
    """BatchNormalizationLayer (layers.py batch_norm_layer)."""
    out = fl.batch_norm(_var(input), act=act_name(act),
                        momentum=moving_average_fraction,
                        is_test=bool(use_global_stats))
    return _wrap(out, "batch_norm", size=getattr(input, "size", None),
                 parents=[input])


def dropout_layer(input, dropout_rate, name=None):
    out = fl.dropout(_var(input), dropout_prob=dropout_rate)
    return _wrap(out, "dropout", size=getattr(input, "size", None),
                 parents=[input])


def maxout_layer(input, groups, num_channels=None, name=None):
    helper = LayerHelper("maxout")
    iv = _var(input)
    out = helper.create_tmp_variable(iv.dtype, shape=None)
    helper.append_op("maxout", inputs={"X": [iv.name]},
                     outputs={"Out": [out.name]}, attrs={"groups": groups})
    return _wrap(out, "maxout", parents=[input])


# --- combination layers ------------------------------------------------------

def concat_layer(input, act=None, name=None):
    """ConcatenateLayer: feature-axis concat (layers.py concat_layer)."""
    out = fl.concat(_vars(input), axis=-1)
    first = input[0]
    lv = get_length_var(_var(first))
    if lv is not None:
        propagate_length(_var(first), out)
    out = _apply_act(out, act)
    size = sum(i.size for i in input if isinstance(i, LayerOutput)) \
        if all(isinstance(i, LayerOutput) and i.size for i in input) else None
    return _wrap(out, "concat", size=size, parents=list(input), name=name)


def addto_layer(input, act=None, bias_attr=None, name=None):
    """AddtoLayer: elementwise sum of inputs (layers.py addto_layer)."""
    vs = _vars(input)
    out = vs[0]
    for v in vs[1:]:
        out = fl.elementwise_add(out, v)
    lv = get_length_var(vs[0])
    if lv is not None:
        propagate_length(vs[0], out)
    out = _apply_act(out, act)
    return _wrap(out, "addto", size=getattr(input[0], "size", None),
                 parents=list(input), name=name)


# --- mixed layer + projections ----------------------------------------------

class _Projection:
    def __init__(self, fn, size_hint=None):
        self.fn = fn
        self.size_hint = size_hint


def full_matrix_projection(input, size=0, param_attr=None):
    def fn(target_size):
        return fl.fc(_var(input), size=target_size,
                     param_attr=to_param_attr(param_attr))
    return _Projection(fn, size_hint=size)


def identity_projection(input, offset=None):
    def fn(target_size):
        return _var(input)
    return _Projection(fn, size_hint=getattr(input, "size", None))


def table_projection(input, size, param_attr=None):
    def fn(target_size):
        vocab = input.size
        return fl.embedding(_var(input), size=[vocab, target_size],
                            param_attr=to_param_attr(param_attr))
    return _Projection(fn, size_hint=size)


def dotmul_projection(input, param_attr=None):
    def fn(target_size):
        helper = LayerHelper("dotmul", param_attr=to_param_attr(param_attr))
        iv = _var(input)
        w = helper.create_parameter(
            attr=to_param_attr(param_attr) or {},
            shape=[int(iv.shape[-1])], dtype=iv.dtype)
        return fl.elementwise_mul(iv, w)
    return _Projection(fn, size_hint=getattr(input, "size", None))


def trans_full_matrix_projection(input, size=0, param_attr=None):
    """TransposedFullMatrixProjection (reference layers.py
    trans_full_matrix_projection:735): out = x @ W^T, sharing the [size,
    in_dim]-shaped weight so an fc elsewhere can reuse it transposed."""
    def fn(target_size):
        if not target_size:
            raise ValueError(
                "trans_full_matrix_projection needs a resolvable size: pass "
                "size= to the projection or to the enclosing mixed_layer")
        helper = LayerHelper("trans_fc", param_attr=to_param_attr(param_attr))
        iv = _var(input)
        w = helper.create_parameter(
            attr=to_param_attr(param_attr) or {},
            shape=[int(target_size), int(iv.shape[-1])], dtype=iv.dtype)
        out = helper.create_tmp_variable(
            iv.dtype, shape=tuple(iv.shape[:-1]) + (int(target_size),))
        helper.append_op("matmul",
                         inputs={"X": [iv.name], "Y": [w.name]},
                         outputs={"Out": [out.name]},
                         attrs={"transpose_X": False, "transpose_Y": True})
        return out
    return _Projection(fn, size_hint=size)


def scaling_projection(input, param_attr=None):
    """ScalingProjection (reference layers.py scaling_projection:649):
    out = w * in with a single trainable scalar."""
    def fn(target_size):
        helper = LayerHelper("scaling_proj",
                             param_attr=to_param_attr(param_attr))
        iv = _var(input)
        w = helper.create_parameter(attr=to_param_attr(param_attr) or {},
                                    shape=[1], dtype=iv.dtype)
        return fl.elementwise_mul(iv, w)
    return _Projection(fn, size_hint=getattr(input, "size", None))


def slice_projection(input, slices):
    """SliceProjection (reference layers.py slice_projection:680): select
    and concatenate [start, end) feature slices; no trainable parameter."""
    start = 0
    for s, e in slices:
        if not (s >= start and e >= s):
            raise ValueError(f"slice_projection: slices must be ordered and "
                             f"non-overlapping, got {slices}")
        start = e
    width = sum(e - s for s, e in slices)

    def fn(target_size):
        helper = LayerHelper("slice_proj")
        iv = _var(input)
        parts = []
        for s, e in slices:
            p = helper.create_tmp_variable(
                iv.dtype, shape=tuple(iv.shape[:-1]) + (e - s,))
            helper.append_op("slice", inputs={"Input": [iv.name]},
                             outputs={"Out": [p.name]},
                             attrs={"axes": [len(iv.shape) - 1],
                                    "starts": [int(s)], "ends": [int(e)]})
            parts.append(p)
        return parts[0] if len(parts) == 1 else fl.concat(parts, axis=-1)
    return _Projection(fn, size_hint=width)


def conv_projection(input, filter_size, num_filters, num_channels=None,
                    stride=1, padding=0, filter_size_y=None, stride_y=None,
                    padding_y=None, groups=1, param_attr=None, trans=False):
    """ConvProjection / ConvTransProjection (reference layers.py
    conv_projection:772): a conv with its own filter parameter usable inside
    mixed_layer; spatial attrs mirror img_conv_layer."""
    ky = filter_size_y if filter_size_y is not None else filter_size
    sy = stride_y if stride_y is not None else stride
    py = padding_y if padding_y is not None else padding

    def fn(target_size):
        iv = _var(input)
        out = img_conv_layer(
            input if isinstance(input, LayerOutput) else _wrap(iv, "in"),
            filter_size=[int(ky), int(filter_size)],
            num_filters=num_filters, num_channels=num_channels,
            stride=[int(sy), int(stride)], padding=[int(py), int(padding)],
            groups=groups, param_attr=param_attr, bias_attr=False,
            trans=trans)
        return fl.reshape(_var(out), [0, -1])
    return _Projection(fn, size_hint=None)


def conv_operator(img, filter, filter_size, num_filters, num_channels=None,
                  stride=1, padding=0, filter_size_y=None, stride_y=None,
                  padding_y=None, trans=False):
    """ConvOperator (reference layers.py conv_operator:1444;
    gserver ConvOperator): PER-SAMPLE convolution whose filter comes from
    another layer's output (operators own no parameters).  Lowered as one
    grouped conv with batch-as-groups — img [B,C,H,W] packs to
    [1,B*C,H,W], filters to [B*F,C,kh,kw], feature_group_count=B — so the
    dynamic-filter conv still runs as a single convolution."""
    if trans:
        raise NotImplementedError(
            "conv_operator(trans=True) (ConvTransOperator): per-sample "
            "TRANSPOSED convolution is not lowered yet; use "
            "conv_projection(trans=True) for the parameterized form")
    ky = int(filter_size_y if filter_size_y is not None else filter_size)
    kx = int(filter_size)
    sy = int(stride_y if stride_y is not None else stride)
    sx = int(stride)
    py = int(padding_y if padding_y is not None else padding)
    px = int(padding)

    def fn(target_size):
        helper = LayerHelper("conv_op")
        iv, fv = _var(img), _var(filter)
        C = int(num_channels) if num_channels is not None else int(iv.shape[1])
        H, W = int(iv.shape[2]), int(iv.shape[3])
        F = int(num_filters)
        x2 = fl.reshape(_var(img), [1, -1, H, W])
        w = fl.reshape(fv, [-1, C, ky, kx])
        out = helper.create_tmp_variable(iv.dtype, shape=None)
        helper.append_op(
            "conv2d", inputs={"Input": [x2.name], "Filter": [w.name]},
            outputs={"Output": [out.name]},
            attrs={"strides": [sy, sx], "paddings": [py, px], "groups": -1})
        oh = (H + 2 * py - ky) // sy + 1
        ow = (W + 2 * px - kx) // sx + 1
        return fl.reshape(out, [-1, F * oh * ow])
    return _Projection(fn, size_hint=None)


def dotmul_operator(a=None, b=None, scale=1, **kwargs):
    """DotMulOperator (reference layers.py dotmul_operator:609):
    out += scale * (a .* b); parameterless."""
    a = a or kwargs.get("x")
    b = b or kwargs.get("y")

    def fn(target_size):
        out = fl.elementwise_mul(_var(a), _var(b))
        if scale != 1:
            out = fl.scale(out, scale=float(scale))
        return out
    return _Projection(fn, size_hint=getattr(a, "size", None))


class MixedLayerType:
    """`with mixed_layer(size=...) as m: m += projection` form (reference
    layers.py MixedLayerType:823/842 — __iadd__ collects projections, exit
    finalizes the sum)."""

    def __init__(self, size, act, bias_attr, name):
        self.size = size
        self.act = act
        self.bias_attr = bias_attr
        self._name = name
        self._projs = []
        self._out = None

    def __iadd__(self, proj):
        self._projs.append(proj)
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        if exc_type is None:
            self._out = mixed_layer(size=self.size, input=self._projs,
                                    act=self.act, bias_attr=self.bias_attr,
                                    name=self._name)

    # after the `with` block the object is used as a LayerOutput
    def __getattr__(self, item):
        out = object.__getattribute__(self, "_out")
        if out is None:
            raise AttributeError(item)
        return getattr(out, item)


def mixed_layer(size=0, input=None, act=None, bias_attr=None, name=None):
    """MixedLayer (layers.py mixed_layer): sums its projections.  The 12
    projection/operator types of the reference reduce to these four plus the
    conv/context operators available as standalone layers.  With input=None
    returns a MixedLayerType for the `with ... as m: m += proj` form."""
    if input is None:
        return MixedLayerType(size, act, bias_attr, name)
    projs = input if isinstance(input, (list, tuple)) else [input]
    acc = None
    for p in projs:
        v = p.fn(size or p.size_hint)
        acc = v if acc is None else fl.elementwise_add(acc, v)
    acc = _apply_act(acc, act)
    return _wrap(acc, "mixed", size=size or projs[0].size_hint, name=name,
                 act=act_name(act))


# --- sequence layers ---------------------------------------------------------

def pooling_layer(input, pooling_type=None, name=None, agg_level=None):
    """SequencePoolLayer (layers.py pooling_layer)."""
    pt = pool_name(pooling_type or AvgPooling)
    out = fl.sequence_pool(_var(input), pool_type=pt)
    return _wrap(out, "seqpool", size=getattr(input, "size", None),
                 parents=[input])


def last_seq(input, name=None, agg_level=None):
    out = fl.sequence_pool(_var(input), pool_type="last")
    return _wrap(out, "last_seq", size=getattr(input, "size", None),
                 parents=[input])


def first_seq(input, name=None, agg_level=None):
    out = fl.sequence_pool(_var(input), pool_type="first")
    return _wrap(out, "first_seq", size=getattr(input, "size", None),
                 parents=[input])


def expand_layer(input, expand_as, name=None):
    """ExpandLayer: broadcast one row per sequence over its steps."""
    helper = LayerHelper("sequence_expand")
    iv, ev = _var(input), _var(expand_as)
    lv = get_length_var(ev)
    T = ev.shape[1] if ev.shape else None
    out = helper.create_tmp_variable(iv.dtype, shape=None)
    helper.append_op(
        "sequence_expand",
        inputs={"X": [iv.name], "Length": [lv.name if lv is not None else ""]},
        outputs={"Out": [out.name]}, attrs={"max_len": int(T)})
    if lv is not None:
        propagate_length(ev, out)
    return _wrap(out, "expand", size=getattr(input, "size", None),
                 parents=[input, expand_as])


def lstmemory(input, size=None, reverse=False, act=None, gate_act=None,
              state_act=None, param_attr=None, bias_attr=None, name=None):
    """LstmLayer (layers.py lstmemory): input must already be the 4x
    projection (as in v1, where mixed/fc feeds it)."""
    iv = _var(input)
    H = size or int(iv.shape[-1]) // 4
    if reverse:
        iv = fl.sequence_reverse(iv)
    hidden, _ = fl.dynamic_lstm(iv, size=4 * H,
                                param_attr=to_param_attr(param_attr))
    if reverse:
        hidden = fl.sequence_reverse(hidden)
    return _wrap(hidden, "lstmemory", size=H, parents=[input])


def grumemory(input, size=None, reverse=False, act=None, gate_act=None,
              param_attr=None, bias_attr=None, name=None):
    """GruLayer (layers.py grumemory): input is the 3x projection."""
    iv = _var(input)
    H = size or int(iv.shape[-1]) // 3
    if reverse:
        iv = fl.sequence_reverse(iv)
    hidden = fl.dynamic_gru(iv, size=H, param_attr=to_param_attr(param_attr))
    if reverse:
        hidden = fl.sequence_reverse(hidden)
    return _wrap(hidden, "grumemory", size=H, parents=[input])


def context_projection(input, context_len, context_start=None):
    def fn(target_size):
        return fl.sequence_conv(_var(input), num_filters=target_size,
                                filter_size=context_len)
    return _Projection(fn)


def seq_reshape_layer(input, reshape_size, name=None):
    helper = LayerHelper("sequence_reshape")
    iv = _var(input)
    lv = get_length_var(iv)
    out = helper.create_tmp_variable(iv.dtype, shape=None)
    lout = helper.create_tmp_variable("int32", shape=None)
    helper.append_op(
        "sequence_reshape",
        inputs={"X": [iv.name], "Length": [lv.name]},
        outputs={"Out": [out.name], "LengthOut": [lout.name]},
        attrs={"new_dim": int(reshape_size)})
    from ..layers.sequence import _set_length

    _set_length(out, lout.name)
    return _wrap(out, "seq_reshape", size=reshape_size, parents=[input])


# --- elementwise utility layers ---------------------------------------------

def trans_layer(input, name=None):
    out = fl.transpose(_var(input), perm=[1, 0])
    return _wrap(out, "trans", parents=[input])


def scaling_layer(input, weight, name=None):
    """ScalingLayer: per-row scalar weight times input."""
    out = fl.elementwise_mul(_var(input), _var(weight))
    return _wrap(out, "scaling", size=getattr(input, "size", None))


def slope_intercept_layer(input, slope=1.0, intercept=0.0, name=None):
    out = fl.scale(_var(input), scale=float(slope), bias=float(intercept))
    return _wrap(out, "slope_intercept", size=getattr(input, "size", None))


def interpolation_layer(input, weight, name=None):
    """out = w*a + (1-w)*b (layers.py interpolation_layer)."""
    a, b = input
    w = _var(weight)
    wa = fl.elementwise_mul(_var(a), w)
    one_minus = fl.scale(w, scale=-1.0, bias=1.0)
    wb = fl.elementwise_mul(_var(b), one_minus)
    return _wrap(fl.elementwise_add(wa, wb), "interpolation",
                 size=getattr(a, "size", None))


def power_layer(input, weight, name=None):
    helper = LayerHelper("pow")
    iv, wv = _var(input), _var(weight)
    out = helper.create_tmp_variable(iv.dtype, shape=iv.shape)
    helper.append_op("elementwise_pow",
                     inputs={"X": [iv.name], "Y": [wv.name]},
                     outputs={"Out": [out.name]}, attrs={})
    return _wrap(out, "power", size=getattr(input, "size", None))


def clip_layer(input, min, max, name=None):
    helper = LayerHelper("clip")
    iv = _var(input)
    out = helper.create_tmp_variable(iv.dtype, shape=iv.shape)
    helper.append_op("clip", inputs={"X": [iv.name]},
                     outputs={"Out": [out.name]},
                     attrs={"min": float(min), "max": float(max)})
    return _wrap(out, "clip", size=getattr(input, "size", None))


def cos_sim(a, b, scale=1.0, size=1, name=None):
    helper = LayerHelper("cos_sim")
    av, bv = _var(a), _var(b)
    out = helper.create_tmp_variable(av.dtype, shape=(av.shape[0], 1))
    helper.append_op("cos_sim", inputs={"X": [av.name], "Y": [bv.name]},
                     outputs={"Out": [out.name]})
    if scale != 1.0:
        out = fl.scale(out, scale=float(scale))
    return _wrap(out, "cos_sim", size=1)


def tensor_layer(a, b, size, act=None, param_attr=None, bias_attr=None,
                 name=None):
    """TensorLayer → bilinear_tensor_product."""
    helper = LayerHelper("bilinear", param_attr=to_param_attr(param_attr))
    av, bv = _var(a), _var(b)
    w = helper.create_parameter(
        attr=to_param_attr(param_attr) or {},
        shape=[size, int(av.shape[-1]), int(bv.shape[-1])], dtype=av.dtype)
    out = helper.create_tmp_variable(av.dtype, shape=(av.shape[0], size))
    helper.append_op("bilinear_tensor_product",
                     inputs={"X": [av.name], "Y": [bv.name], "Weight": [w.name]},
                     outputs={"Out": [out.name]})
    return _wrap(_apply_act(out, act), "tensor", size=size)


def max_id_layer(input, name=None):
    helper = LayerHelper("arg_max")
    iv = _var(input)
    out = helper.create_tmp_variable("int64", shape=(iv.shape[0], 1))
    helper.append_op("arg_max", inputs={"X": [iv.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": -1})
    return _wrap(out, "max_id", size=1, parents=[input])


maxid_layer = max_id_layer  # reference name (layers.py maxid_layer:4252)


def conv_shift_layer(a, b, name=None):
    helper = LayerHelper("conv_shift")
    av, bv = _var(a), _var(b)
    out = helper.create_tmp_variable(av.dtype, shape=av.shape)
    helper.append_op("conv_shift", inputs={"X": [av.name], "Y": [bv.name]},
                     outputs={"Out": [out.name]})
    return _wrap(out, "conv_shift", size=getattr(a, "size", None))


# --- cost layers -------------------------------------------------------------

def classification_cost(input, label, name=None, evaluator=None,
                        layer_attr=None):
    """Softmax + cross-entropy (layers.py classification_cost).  v1 applied
    softmax via the input layer's activation; accept either way."""
    iv = _var(input)
    ce = fl.cross_entropy(fl.softmax(iv) if _needs_softmax(input) else iv,
                          _var(label))
    out = fl.mean(ce)
    return _wrap(out, "cost", size=1, parents=[input, label])


def _needs_softmax(input):
    # fc_layer(..., act=SoftmaxActivation()) is already normalized
    return getattr(input, "act", None) != "softmax"


def regression_cost(input, label, name=None):
    out = fl.mean(fl.square_error_cost(_var(input), _var(label)))
    return _wrap(out, "cost", size=1, parents=[input, label])


mse_cost = regression_cost


def cross_entropy_cost(input, label, name=None):
    out = fl.mean(fl.cross_entropy(_var(input), _var(label)))
    return _wrap(out, "cost", size=1)


def multi_binary_label_cross_entropy(input, label, name=None):
    helper = LayerHelper("sce")
    iv, lv = _var(input), _var(label)
    out = helper.create_tmp_variable(iv.dtype, shape=iv.shape)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     inputs={"X": [iv.name], "Label": [lv.name]},
                     outputs={"Out": [out.name]})
    return _wrap(fl.mean(out), "cost", size=1)


cross_entropy = cross_entropy_cost  # reference name (layers.py:6073)


class BeamInput:
    """One beam expansion for cross_entropy_over_beam (reference layers.py
    BeamInput:5774): candidate scores, the kmax-selected candidates, and
    the gold candidate index."""

    def __init__(self, candidate_scores, selected_candidates, gold):
        self.candidate_scores = candidate_scores
        self.selected_candidates = selected_candidates
        self.gold = gold


def cross_entropy_over_beam(input, name=None):
    """CrossEntropyOverBeamLayer (reference layers.py
    cross_entropy_over_beam:5804; gserver/layers/CrossEntropyOverBeam.cpp):
    sum of per-expansion cross-entropies over the beam search path."""
    beams = input if isinstance(input, (list, tuple)) else [input]
    helper = LayerHelper("cross_entropy_over_beam")
    total = None
    for b in beams:
        sv = _var(b.candidate_scores)
        cv = _var(b.selected_candidates)
        gv = _var(b.gold)
        inputs = {"X": [sv.name], "Ids": [cv.name], "Label": [gv.name]}
        lv = get_length_var(sv)
        if lv is not None:  # beams wider than a short sequence: mask pads
            inputs["Length"] = [lv.name]
        out = helper.create_tmp_variable(sv.dtype, shape=None)
        helper.append_op(
            "cross_entropy_over_beam", inputs=inputs,
            outputs={"Out": [out.name]})
        total = out if total is None else fl.elementwise_add(total, out)
    return _wrap(fl.mean(total), "cost", size=1,
                 parents=[b.candidate_scores for b in beams], name=name)


def cross_entropy_with_selfnorm(input, label, name=None, coeff=1.0,
                                softmax_selfnorm_alpha=0.1, layer_attr=None):
    """CrossEntropyWithSelfNorm (reference layers.py:6120)."""
    helper = LayerHelper("ce_selfnorm")
    iv = _var(input)
    out = helper.create_tmp_variable(iv.dtype, shape=None)
    helper.append_op(
        "cross_entropy_selfnorm",
        inputs={"X": [iv.name], "Label": [_var(label).name]},
        outputs={"Out": [out.name]},
        attrs={"softmax_selfnorm_alpha": float(softmax_selfnorm_alpha)})
    out = fl.mean(out)
    if coeff != 1.0:
        out = fl.scale(out, scale=float(coeff))
    return _wrap(out, "cost", size=1, parents=[input, label], name=name)


def huber_classification_cost(input, label, name=None, coeff=1.0,
                              layer_attr=None):
    """HuberTwoClassification (reference layers.py:6258)."""
    helper = LayerHelper("huber_cls")
    iv = _var(input)
    out = helper.create_tmp_variable(iv.dtype, shape=None)
    helper.append_op("huber_classification",
                     inputs={"X": [iv.name], "Label": [_var(label).name]},
                     outputs={"Out": [out.name]})
    out = fl.mean(out)
    if coeff != 1.0:
        out = fl.scale(out, scale=float(coeff))
    return _wrap(out, "cost", size=1, parents=[input, label], name=name)


def smooth_l1_cost(input, label, name=None, coeff=1.0, layer_attr=None):
    """SmoothL1Cost (reference layers.py smooth_l1_cost:6471)."""
    helper = LayerHelper("smooth_l1")
    iv = _var(input)
    out = helper.create_tmp_variable(iv.dtype, shape=None)
    diff = helper.create_tmp_variable(iv.dtype, shape=None)
    helper.append_op("smooth_l1_loss",
                     inputs={"X": [iv.name], "Y": [_var(label).name]},
                     outputs={"Out": [out.name], "Diff": [diff.name]})
    out = fl.mean(out)
    if coeff != 1.0:
        out = fl.scale(out, scale=float(coeff))
    return _wrap(out, "cost", size=1, parents=[input, label], name=name)


def lambda_cost(input, score, name=None, NDCG_num=5, max_sort_size=-1,
                layer_attr=None):
    """LambdaCost for LambdaRank LTR (reference layers.py lambda_cost:6015):
    input = per-document scores over a query sequence, score = relevance
    labels."""
    helper = LayerHelper("lambda_cost")
    iv, sv = _var(input), _var(score)
    lv = _get_length_strict(iv)
    out = helper.create_tmp_variable(iv.dtype, shape=None)
    helper.append_op(
        "lambda_rank",
        inputs={"X": [iv.name], "Score": [sv.name], "Length": [lv.name]},
        outputs={"Out": [out.name]},
        attrs={"NDCG_num": int(NDCG_num),
               "max_sort_size": int(max_sort_size)})
    return _wrap(fl.mean(out), "cost", size=1, parents=[input, score],
                 name=name)


def rank_cost(left, right, label, weight=None, name=None):
    helper = LayerHelper("rank_loss")
    out = helper.create_tmp_variable(_var(left).dtype, shape=(1,))
    helper.append_op("rank_loss",
                     inputs={"Left": [_var(left).name],
                             "Right": [_var(right).name],
                             "Label": [_var(label).name]},
                     outputs={"Out": [out.name]})
    return _wrap(fl.mean(out), "cost", size=1)


def huber_regression_cost(input, label, delta=1.0, name=None):
    helper = LayerHelper("huber_loss")
    iv = _var(input)
    out = helper.create_tmp_variable(iv.dtype, shape=iv.shape)
    resid = helper.create_tmp_variable(iv.dtype, shape=iv.shape)
    helper.append_op("huber_loss",
                     inputs={"X": [iv.name], "Y": [_var(label).name]},
                     outputs={"Out": [out.name], "Residual": [resid.name]},
                     attrs={"delta": float(delta)})
    return _wrap(fl.mean(out), "cost", size=1)


def crf_layer(input, label, param_attr=None, name=None):
    """CRFLayer: linear-chain CRF negative log-likelihood."""
    ll, _trans = fl.linear_chain_crf(_var(input), _var(label),
                                     param_attr=to_param_attr(param_attr))
    out = fl.mean(fl.scale(ll, scale=-1.0))
    lo = _wrap(out, "crf", size=1, parents=[input, label])
    lo.transition = _trans
    return lo


def crf_decoding_layer(input, transition, name=None):
    out = fl.crf_decoding(_var(input), _var(transition))
    return _wrap(out, "crf_decoding", parents=[input])


def ctc_layer(input, label, size=None, blank=None, norm_by_times=False,
              name=None):
    """CTCLayer / warp_ctc_layer (layers.py ctc_layer): CTC loss over padded
    logits + padded labels with companion lengths."""
    helper = LayerHelper("warpctc")
    iv, lv = _var(input), _var(label)
    ilen = get_length_var(iv)
    llen = get_length_var(lv)
    loss = helper.create_tmp_variable(iv.dtype, shape=None)
    grad = helper.create_tmp_variable(iv.dtype, shape=None)
    helper.append_op(
        "warpctc",
        inputs={"Logits": [iv.name], "Label": [lv.name],
                "LogitsLength": [ilen.name], "LabelLength": [llen.name]},
        outputs={"Loss": [loss.name], "WarpCTCGrad": [grad.name]},
        attrs={"blank": int(blank if blank is not None
                            else (size or int(iv.shape[-1])) - 1)})
    return _wrap(fl.mean(loss), "ctc", size=1)


warp_ctc_layer = ctc_layer


def nce_layer(input, label, num_classes, num_neg_samples=10, param_attr=None,
              bias_attr=None, name=None):
    helper = LayerHelper("nce", param_attr=to_param_attr(param_attr))
    iv, lv = _var(input), _var(label)
    D = int(iv.shape[-1])
    w = helper.create_parameter(attr=to_param_attr(param_attr) or {},
                                shape=[num_classes, D], dtype=iv.dtype)
    b = helper.create_parameter(attr={}, shape=[num_classes], dtype=iv.dtype)
    cost = helper.create_tmp_variable(iv.dtype, shape=None)
    helper.append_op(
        "nce",
        inputs={"Input": [iv.name], "Label": [lv.name], "Weight": [w.name],
                "Bias": [b.name]},
        outputs={"Cost": [cost.name]},
        attrs={"num_total_classes": int(num_classes),
               "num_neg_samples": int(num_neg_samples)})
    return _wrap(fl.mean(cost), "nce", size=1)


def sum_cost(input, name=None):
    helper = LayerHelper("reduce_sum")
    iv = _var(input)
    out = helper.create_tmp_variable(iv.dtype, shape=(1,))
    helper.append_op("reduce_sum", inputs={"X": [iv.name]},
                     outputs={"Out": [out.name]},
                     attrs={"dim": None, "keep_dim": False})
    return _wrap(out, "cost", size=1)


# --- graph finalize ----------------------------------------------------------

_declared_outputs: list = []


def outputs(*layers):
    """Mark network outputs (config_parser outputs()).  Returns the fluid
    Variables so callers can fetch them; also records them so the `paddle
    train --config` driver can find the config's cost after exec."""
    _declared_outputs[:] = list(layers)
    return [_var(l) for l in layers]


def declared_outputs():
    """The LayerOutputs recorded by the last outputs() call."""
    return list(_declared_outputs)


def parse_network(*outputs_) -> Program:
    """The config_parser.parse_config equivalent: v1 configs built these
    functions into a ModelConfig proto (config_parser.py:4345); here the
    Program *is* the config — return it (serializable via
    framework.proto_io).  A single callable argument is the reference's
    non-file-config form (tests/configs/test_config_parser_for_non_file_
    config.py): invoke it to build the net, then return the Program."""
    if len(outputs_) == 1 and callable(outputs_[0]) \
            and not isinstance(outputs_[0], (LayerOutput, Variable)):
        outputs_[0]()
    return default_main_program()


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    """HierarchicalSigmoidLayer (layers.py hsigmoid): O(log C) softmax
    substitute for huge class counts."""
    helper = LayerHelper("hsigmoid", param_attr=to_param_attr(param_attr))
    iv, lv = _var(input), _var(label)
    D = int(iv.shape[-1])
    w = helper.create_parameter(attr=to_param_attr(param_attr) or {},
                                shape=[num_classes - 1, D], dtype=iv.dtype)
    inputs = {"X": [iv.name], "W": [w.name], "Label": [lv.name]}
    if bias_attr is not False:  # False = no bias (v1 convention)
        b = helper.create_parameter(attr=to_param_attr(bias_attr) or {},
                                    shape=[num_classes - 1], dtype=iv.dtype,
                                    is_bias=True)
        inputs["Bias"] = [b.name]
    out = helper.create_tmp_variable(iv.dtype, shape=(iv.shape[0], 1))
    helper.append_op(
        "hsigmoid", inputs=inputs, outputs={"Out": [out.name]},
        attrs={"num_classes": int(num_classes)})
    return _wrap(fl.mean(out), "hsigmoid", size=1, parents=[input, label])


def factorization_machine(input, factor_size, param_attr=None, name=None):
    """FactorizationMachineLayer (layers.py factorization_machine)."""
    helper = LayerHelper("fm", param_attr=to_param_attr(param_attr))
    iv = _var(input)
    D = int(iv.shape[-1])
    v = helper.create_parameter(attr=to_param_attr(param_attr) or {},
                                shape=[D, factor_size], dtype=iv.dtype)
    out = helper.create_tmp_variable(iv.dtype, shape=(iv.shape[0], 1))
    helper.append_op(
        "factorization_machine",
        inputs={"Input": [iv.name], "Factors": [v.name]},
        outputs={"Out": [out.name]}, attrs={})
    return _wrap(out, "factorization_machine", size=1, parents=[input])


def selective_fc_layer(input, size, select=None, act=None, param_attr=None,
                       bias_attr=None, name=None):
    """SelectiveFullyConnectedLayer (layers.py selective_fc_layer)."""
    helper = LayerHelper("selective_fc",
                         param_attr=to_param_attr(param_attr))
    iv = _var(input)
    D = int(iv.shape[-1])
    w = helper.create_parameter(attr=to_param_attr(param_attr) or {},
                                shape=[D, size], dtype=iv.dtype)
    out = helper.create_tmp_variable(iv.dtype, shape=(iv.shape[0], size))
    inputs = {"X": [iv.name], "W": [w.name]}
    if bias_attr is not False:
        b = helper.create_parameter(attr=to_param_attr(bias_attr) or {},
                                    shape=[size], dtype=iv.dtype,
                                    is_bias=True)
        inputs["Bias"] = [b.name]
    if select is not None:
        inputs["Mask"] = [_var(select).name]
    helper.append_op("selective_fc", inputs=inputs,
                     outputs={"Out": [out.name]}, attrs={})
    return _wrap(_apply_act(out, act), "selective_fc", size=size,
                 parents=[input])


# ===========================================================================
# Round-2 additions: the remaining reference *_layer functions
# (reference trainer_config_helpers/layers.py; each docstring cites the
# originating Layer class / op)
# ===========================================================================

# --- elementwise / shape utility layers -------------------------------------

def repeat_layer(input, num_repeats, as_row_vector=True, act=None, name=None,
                 layer_attr=None):
    """FeatureMapExpandLayer (reference layers.py repeat_layer:1914):
    as_row_vector repeats the whole feature row [x1..xn,x1..xn]; otherwise
    each element is repeated in place [x1,x1,..,xn,xn]."""
    iv = _var(input)
    D = int(iv.shape[-1])
    if as_row_vector:
        out = fl.concat([iv] * int(num_repeats), axis=-1)
    else:
        helper = LayerHelper("repeat")
        r = fl.reshape(iv, [-1, D, 1])
        tiled = helper.create_tmp_variable(iv.dtype, shape=None)
        helper.append_op("expand", inputs={"X": [r.name]},
                         outputs={"Out": [tiled.name]},
                         attrs={"expand_times": [1, 1, int(num_repeats)]})
        out = fl.reshape(tiled, [-1, D * int(num_repeats)])
    out = _apply_act(out, act)
    sz = (input.size * num_repeats
          if isinstance(input, LayerOutput) and input.size else None)
    return _wrap(out, "featmap_expand", size=sz, parents=[input], name=name)


def resize_layer(input, size, name=None):
    """ResizeLayer (reference layers.py resize_layer:7340): reflow the batch
    matrix to rows of `size` values."""
    out = fl.reshape(_var(input), [-1, int(size)])
    return _wrap(out, "resize", size=size, parents=[input], name=name)


def rotate_layer(input, height, width, name=None, layer_attr=None):
    """RotateLayer (reference layers.py rotate_layer:2266): rotate each CHW
    feature map 90 degrees clockwise: y(j,i) = x(M-i-1, j)."""
    helper = LayerHelper("rotate")
    iv = _var(input)
    if len(iv.shape or ()) != 4:
        c = int(input.size) // (height * width)
        iv = fl.reshape(iv, [-1, c, int(height), int(width)])
    flipped = helper.create_tmp_variable(iv.dtype, shape=None)
    helper.append_op("reverse", inputs={"X": [iv.name]},
                     outputs={"Out": [flipped.name]}, attrs={"axis": [2]})
    out = fl.transpose(flipped, perm=[0, 1, 3, 2])
    return _wrap(out, "rotate", size=getattr(input, "size", None),
                 parents=[input], name=name)


def switch_order_layer(input, name=None, reshape_axis=None, act=None,
                       layer_attr=None):
    """SwitchOrderLayer (reference layers.py switch_order_layer:6866):
    NCHW -> NHWC dimension switch."""
    out = fl.transpose(_var(input), perm=[0, 2, 3, 1])
    out = _apply_act(out, act)
    return _wrap(out, "switch_order", size=getattr(input, "size", None),
                 parents=[input], name=name)


def sum_to_one_norm_layer(input, name=None, layer_attr=None):
    """SumToOneNormLayer (reference layers.py sum_to_one_norm_layer:3295):
    x / sum(x) per row."""
    helper = LayerHelper("sum_to_one")
    iv = _var(input)
    s = helper.create_tmp_variable(iv.dtype, shape=None)
    helper.append_op("reduce_sum", inputs={"X": [iv.name]},
                     outputs={"Out": [s.name]},
                     attrs={"dim": [-1], "keep_dim": True})
    out = fl.elementwise_div(iv, s)
    return _wrap(out, "sum_to_one_norm", size=getattr(input, "size", None),
                 parents=[input], name=name)


def row_l2_norm_layer(input, name=None, layer_attr=None):
    """RowL2NormLayer (reference layers.py row_l2_norm_layer:3333):
    x / ||x||_2 per row."""
    helper = LayerHelper("row_l2_norm")
    iv = _var(input)
    out = helper.create_tmp_variable(iv.dtype, shape=iv.shape)
    helper.append_op("norm", inputs={"X": [iv.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": -1,
                                                         "epsilon": 1e-12})
    return _wrap(out, "row_l2_norm", size=getattr(input, "size", None),
                 parents=[input], name=name)


def dot_prod_layer(input1, input2, name=None, layer_attr=None):
    """DotProdLayer (reference layers.py dot_prod_layer:4288): per-row inner
    product -> [B, 1]."""
    helper = LayerHelper("dot_prod")
    prod = fl.elementwise_mul(_var(input1), _var(input2))
    out = helper.create_tmp_variable(prod.dtype, shape=None)
    helper.append_op("reduce_sum", inputs={"X": [prod.name]},
                     outputs={"Out": [out.name]},
                     attrs={"dim": [-1], "keep_dim": True})
    return _wrap(out, "dot_prod", size=1, parents=[input1, input2], name=name)


def out_prod_layer(input1, input2, name=None, layer_attr=None):
    """OuterProdLayer (reference layers.py out_prod_layer:4327): batched outer
    product flattened to [B, M*N]."""
    helper = LayerHelper("out_prod")
    av, bv = _var(input1), _var(input2)
    M, N = int(av.shape[-1]), int(bv.shape[-1])
    a3 = fl.reshape(av, [-1, M, 1])
    b3 = fl.reshape(bv, [-1, 1, N])
    out = helper.create_tmp_variable(av.dtype, shape=None)
    helper.append_op("matmul", inputs={"X": [a3.name], "Y": [b3.name]},
                     outputs={"Out": [out.name]}, attrs={})
    flat = fl.reshape(out, [-1, M * N])
    return _wrap(flat, "out_prod", size=M * N, parents=[input1, input2],
                 name=name)


def l2_distance_layer(x, y, name=None, layer_attr=None):
    """L2DistanceLayer (reference layers.py l2_distance_layer:2374):
    sqrt(sum((x-y)^2)) per row -> [B, 1]."""
    helper = LayerHelper("l2_distance")
    sq = helper.create_tmp_variable(_var(x).dtype, shape=None)
    helper.append_op("squared_l2_distance",
                     inputs={"X": [_var(x).name], "Y": [_var(y).name]},
                     outputs={"Out": [sq.name], "sub_result": [""]})
    out = helper.create_tmp_variable(_var(x).dtype, shape=None)
    helper.append_op("sqrt", inputs={"X": [sq.name]},
                     outputs={"Out": [out.name]})
    return _wrap(out, "l2_distance", size=1, parents=[x, y], name=name)


def scale_shift_layer(input, name=None, param_attr=None, bias_attr=None):
    """ScaleShiftLayer (reference layers.py scale_shift_layer:7299):
    y = w*x + b with scalar trainable w (and b unless bias_attr=False)."""
    helper = LayerHelper("scale_shift", param_attr=to_param_attr(param_attr))
    iv = _var(input)
    w = helper.create_parameter(attr=to_param_attr(param_attr) or {},
                                shape=[1], dtype=iv.dtype)
    out = fl.elementwise_mul(iv, w)
    if bias_attr is not False:
        b = helper.create_parameter(attr=to_param_attr(bias_attr) or {},
                                    shape=[1], dtype=iv.dtype, is_bias=True)
        out = fl.elementwise_add(out, b)
    return _wrap(out, "scale_shift", size=getattr(input, "size", None),
                 parents=[input], name=name)


def linear_comb_layer(weights, vectors, size=None, name=None, layer_attr=None):
    """LinearCombinationLayer (reference layers.py linear_comb_layer:5288):
    weights [B,M] x vectors [B,M*N] -> [B,N] (z = w^T V per sample)."""
    helper = LayerHelper("linear_comb")
    wv, vv = _var(weights), _var(vectors)
    M = int(wv.shape[-1])
    MN = int(vv.shape[-1])
    N = int(size) if size is not None else MN // M
    v3 = fl.reshape(vv, [-1, M, N])
    w3 = fl.reshape(wv, [-1, 1, M])
    out = helper.create_tmp_variable(wv.dtype, shape=None)
    helper.append_op("matmul", inputs={"X": [w3.name], "Y": [v3.name]},
                     outputs={"Out": [out.name]}, attrs={})
    flat = fl.reshape(out, [-1, N])
    return _wrap(flat, "convex_comb", size=N, parents=[weights, vectors],
                 name=name)


convex_comb_layer = linear_comb_layer


def multiplex_layer(input, name=None, layer_attr=None):
    """MultiplexLayer (reference layers.py multiplex_layer:6527): input[0]
    holds per-row indices selecting which of input[1:] supplies each row."""
    helper = LayerHelper("multiplex")
    ids = _var(input[0])
    cands = [_var(i) for i in input[1:]]
    out = helper.create_tmp_variable(cands[0].dtype, shape=cands[0].shape)
    helper.append_op("multiplex",
                     inputs={"Ids": [ids.name],
                             "X": [c.name for c in cands]},
                     outputs={"Out": [out.name]})
    return _wrap(out, "multiplex", size=getattr(input[1], "size", None),
                 parents=list(input), name=name)


def sampling_id_layer(input, name=None, layer_attr=None):
    """SamplingIdLayer (reference layers.py sampling_id_layer:5212): sample
    one id per row from the row's multinomial distribution."""
    helper = LayerHelper("sampling_id")
    iv = _var(input)
    out = helper.create_tmp_variable("int64", shape=(iv.shape[0],))
    helper.append_op("sampling_id", inputs={"X": [iv.name]},
                     outputs={"Out": [out.name]})
    return _wrap(out, "sampling_id", size=1, parents=[input], name=name)


def eos_layer(input, eos_id, name=None, layer_attr=None):
    """EosIdCheckLayer (reference layers.py eos_layer:4366): 1 where the id
    equals eos_id."""
    helper = LayerHelper("eos")
    iv = _var(input)
    const = fl.fill_constant(shape=[1], dtype=iv.dtype, value=int(eos_id))
    out = helper.create_tmp_variable("int64", shape=iv.shape)
    helper.append_op("equal", inputs={"X": [iv.name], "Y": [const.name]},
                     outputs={"Out": [out.name]})
    return _wrap(out, "eos", size=1, parents=[input], name=name)


def printer_layer(input, format=None, name=None):
    """PrintLayer (reference layers.py printer_layer:1093): pass-through that
    prints its inputs each step (the `print` op)."""
    ins = input if isinstance(input, (list, tuple)) else [input]
    helper = LayerHelper("printer")
    outs = []
    for i in ins:
        iv = _var(i)
        out = helper.create_tmp_variable(iv.dtype, shape=iv.shape)
        helper.append_op("print", inputs={"X": [iv.name]},
                         outputs={"Out": [out.name]},
                         attrs={"message": format or f"{iv.name}: "})
        outs.append(out)
    return _wrap(outs[0], "print", size=getattr(ins[0], "size", None),
                 parents=list(ins), name=name)


print_layer = printer_layer  # reference alias (layers.py print_layer)


# --- image stack additions ---------------------------------------------------

def pad_layer(input, pad_c=None, pad_h=None, pad_w=None, name=None,
              layer_attr=None):
    """PadLayer (reference layers.py pad_layer:4882): zero-pad CHW axes;
    each pad_* is [begin, end]."""
    helper = LayerHelper("pad")
    iv = _var(input)
    pc = pad_c or [0, 0]
    ph = pad_h or [0, 0]
    pw = pad_w or [0, 0]
    pads = [0, 0, int(pc[0]), int(pc[1]), int(ph[0]), int(ph[1]),
            int(pw[0]), int(pw[1])]
    oshape = None
    if iv.shape is not None:
        oshape = tuple(
            (s if s == -1 else s + pads[2 * i] + pads[2 * i + 1])
            for i, s in enumerate(iv.shape))
    out = helper.create_tmp_variable(iv.dtype, shape=oshape)
    helper.append_op("pad", inputs={"X": [iv.name]},
                     outputs={"Out": [out.name]},
                     attrs={"paddings": pads, "pad_value": 0.0})
    return _wrap(out, "pad", parents=[input], name=name)


def crop_layer(input, offset, axis=2, shape=None, name=None, layer_attr=None):
    """CropLayer (reference layers.py crop_layer:6915): crop NCHW starting at
    `axis` by `offset` to `shape` (or to a reference input's shape)."""
    ins = input if isinstance(input, (list, tuple)) else [input]
    helper = LayerHelper("crop")
    iv = _var(ins[0])
    full = list(iv.shape)
    if shape is None and len(ins) > 1:
        ref = _var(ins[1])
        shape = list(ref.shape)[axis:]
    offsets = [0] * len(full)
    target = list(full)
    for i, (o, s) in enumerate(zip(offset, shape)):
        offsets[axis + i] = int(o)
        target[axis + i] = int(s)
    out = helper.create_tmp_variable(iv.dtype, shape=tuple(target))
    helper.append_op("crop", inputs={"X": [iv.name]},
                     outputs={"Out": [out.name]},
                     attrs={"offsets": offsets, "shape": target})
    return _wrap(out, "crop", parents=list(ins), name=name)


def bilinear_interp_layer(input, out_size_x=None, out_size_y=None, name=None,
                          layer_attr=None):
    """BilinearInterpLayer (reference layers.py bilinear_interp_layer:2087):
    align-corners bilinear resize of NCHW maps."""
    helper = LayerHelper("bilinear_interp")
    iv = _var(input)
    n, c = iv.shape[0], iv.shape[1]
    out = helper.create_tmp_variable(
        iv.dtype, shape=(n, c, int(out_size_y), int(out_size_x)))
    helper.append_op("bilinear_interp", inputs={"X": [iv.name]},
                     outputs={"Out": [out.name]},
                     attrs={"out_h": int(out_size_y),
                            "out_w": int(out_size_x)})
    return _wrap(out, "bilinear_interp", size=getattr(input, "size", None),
                 parents=[input], name=name)


def cross_channel_norm_layer(input, name=None, param_attr=None):
    """CrossChannelNormLayer (reference layers.py
    cross_channel_norm_layer:1375, detection SSD): per-position L2 norm
    across channels with a learned per-channel scale."""
    from ..framework.initializer import ConstantInitializer

    helper = LayerHelper("cross_channel_norm",
                         param_attr=to_param_attr(param_attr))
    iv = _var(input)
    C = int(iv.shape[1])
    scale = helper.create_parameter(
        attr=to_param_attr(param_attr)
        or {"initializer": ConstantInitializer(1.0)},
        shape=[C], dtype=iv.dtype)
    sq = fl.elementwise_mul(iv, iv)
    ssum = helper.create_tmp_variable(iv.dtype, shape=None)
    helper.append_op("reduce_sum", inputs={"X": [sq.name]},
                     outputs={"Out": [ssum.name]},
                     attrs={"dim": [1], "keep_dim": True})
    rsq = helper.create_tmp_variable(iv.dtype, shape=None)
    helper.append_op("sqrt", inputs={"X": [ssum.name]},
                     outputs={"Out": [rsq.name]})
    normed = fl.elementwise_div(iv, rsq)
    s4 = fl.reshape(scale, [1, C, 1, 1])
    out = fl.elementwise_mul(normed, s4)
    return _wrap(out, "cross_channel_norm", size=getattr(input, "size", None),
                 parents=[input], name=name)


def scale_sub_region_layer(input, indices, value, name=None):
    """ScaleSubRegionLayer (reference layers.py scale_sub_region_layer:7414):
    multiply a per-sample CHW box (1-based inclusive [N,6] indices) by
    `value`."""
    helper = LayerHelper("scale_sub_region")
    iv = _var(input)
    out = helper.create_tmp_variable(iv.dtype, shape=iv.shape)
    helper.append_op("scale_sub_region",
                     inputs={"X": [iv.name], "Indices": [_var(indices).name]},
                     outputs={"Out": [out.name]},
                     attrs={"value": float(value)})
    return _wrap(out, "scale_sub_region", size=getattr(input, "size", None),
                 parents=[input, indices], name=name)


def prelu_layer(input, name=None, partial_sum=1, channel_shared=None,
                num_channels=None, param_attr=None, layer_attr=None):
    """ParameterReluLayer (reference layers.py prelu_layer:6683): learnable
    negative-slope; partial_sum/channel_shared control weight sharing."""
    helper = LayerHelper("prelu", param_attr=to_param_attr(param_attr))
    iv = _var(input)
    shape = iv.shape
    if num_channels is None and shape is not None and len(shape) >= 2:
        num_channels = int(shape[1])
    if channel_shared is True or (shape is not None and len(shape) == 2
                                  and partial_sum != 1):
        alpha_shape = [1]
    elif channel_shared is False or (num_channels and partial_sum == 1
                                     and shape is not None
                                     and len(shape) > 2):
        alpha_shape = [num_channels]
    elif partial_sum == 1 and shape is not None and len(shape) == 2:
        alpha_shape = [int(shape[-1])]
    else:
        alpha_shape = [1]
    from ..framework.initializer import ConstantInitializer

    alpha = helper.create_parameter(
        attr=to_param_attr(param_attr)
        or {"initializer": ConstantInitializer(0.25)},
        shape=alpha_shape, dtype=iv.dtype)
    out = helper.create_tmp_variable(iv.dtype, shape=iv.shape)
    helper.append_op("prelu", inputs={"X": [iv.name], "Alpha": [alpha.name]},
                     outputs={"Out": [out.name]})
    return _wrap(out, "prelu", size=getattr(input, "size", None),
                 parents=[input], name=name)


def gated_unit_layer(input, size, act=None, name=None, gate_attr=None,
                     gate_param_attr=None, gate_bias_attr=True,
                     inproj_attr=None, inproj_param_attr=None,
                     inproj_bias_attr=True, layer_attr=None):
    """GatedRecurrentLayer-style gating (reference layers.py
    gated_unit_layer:6773): out = act(W1 x) * sigmoid(W2 x)."""
    proj = fl.fc(_var(input), size=size, act=act_name(act),
                 param_attr=to_param_attr(inproj_param_attr),
                 bias_attr=inproj_bias_attr)
    gate = fl.fc(_var(input), size=size, act="sigmoid",
                 param_attr=to_param_attr(gate_param_attr),
                 bias_attr=gate_bias_attr)
    out = fl.elementwise_mul(proj, gate)
    return _wrap(out, "gated_unit", size=size, parents=[input], name=name)


def row_conv_layer(input, context_len, act=None, name=None, param_attr=None,
                   layer_attr=None):
    """RowConvLayer (reference layers.py row_conv_layer:6611): lookahead
    convolution over a [B,T,D] sequence."""
    helper = LayerHelper("row_conv", param_attr=to_param_attr(param_attr))
    iv = _var(input)
    D = int(iv.shape[-1])
    w = helper.create_parameter(attr=to_param_attr(param_attr) or {},
                                shape=[int(context_len), D], dtype=iv.dtype)
    out = helper.create_tmp_variable(iv.dtype, shape=iv.shape)
    helper.append_op("row_conv", inputs={"X": [iv.name], "Filter": [w.name]},
                     outputs={"Out": [out.name]})
    lv = get_length_var(iv)
    if lv is not None:
        propagate_length(iv, out)
    return _wrap(_apply_act(out, act), "row_conv",
                 size=getattr(input, "size", None), parents=[input],
                 name=name)


def spp_layer(input, name=None, num_channels=None, pool_type=None,
              pyramid_height=None, layer_attr=None):
    """SpatialPyramidPoolLayer (reference layers.py spp_layer:3019)."""
    helper = LayerHelper("spp")
    iv = _var(input)
    pt = pool_name(pool_type or MaxPooling)
    out = helper.create_tmp_variable(iv.dtype, shape=None)
    helper.append_op("spp", inputs={"X": [iv.name]},
                     outputs={"Out": [out.name]},
                     attrs={"pyramid_height": int(pyramid_height),
                            "pooling_type": "avg" if pt in ("average", "avg")
                            else "max"})
    return _wrap(out, "spp", parents=[input], name=name)


def img_conv3d_layer(input, filter_size, num_filters, name=None,
                     num_channels=None, act=None, groups=1, stride=1,
                     padding=0, bias_attr=None, param_attr=None,
                     shared_biases=True, layer_attr=None,
                     trans=False, layer_type="conv3d"):
    """Conv3DLayer (reference layers.py img_conv3d_layer:7153)."""
    helper = LayerHelper("conv3d", param_attr=to_param_attr(param_attr))
    iv = _var(input)  # [N, C, D, H, W]
    C = int(iv.shape[1]) if num_channels is None else int(num_channels)

    def _t(v):
        return [int(x) for x in v] if isinstance(v, (list, tuple)) \
            else [int(v)] * 3

    ks, st, pd = _t(filter_size), _t(stride), _t(padding)
    op = "conv3d_transpose" if (trans or layer_type == "deconv3d") \
        else "conv3d"
    if op == "conv3d":
        wshape = [num_filters, C // groups] + ks
    else:
        wshape = [C, num_filters] + ks
    w = helper.create_parameter(attr=to_param_attr(param_attr) or {},
                                shape=wshape, dtype=iv.dtype)
    out = helper.create_tmp_variable(iv.dtype, shape=None)
    helper.append_op(op, inputs={"Input": [iv.name], "Filter": [w.name]},
                     outputs={"Output": [out.name]},
                     attrs={"strides": st, "paddings": pd, "groups": groups})
    if bias_attr is not False:
        b = helper.create_parameter(attr=to_param_attr(bias_attr) or {},
                                    shape=[num_filters], dtype=iv.dtype,
                                    is_bias=True)
        b5 = fl.reshape(b, [1, num_filters, 1, 1, 1])
        out = fl.elementwise_add(out, b5)
    out = _apply_act(out, act or "relu")
    return _wrap(out, "conv3d", size=num_filters, parents=[input], name=name)


def img_pool3d_layer(input, pool_size, name=None, num_channels=None,
                     pool_type=None, stride=1, padding=0, layer_attr=None,
                     pool_size_y=None, stride_y=None, padding_y=None,
                     pool_size_z=None, stride_z=None, padding_z=None):
    """Pool3DLayer (reference layers.py img_pool3d_layer:2867)."""
    helper = LayerHelper("pool3d")
    iv = _var(input)
    pt = pool_name(pool_type or MaxPooling)

    def _t3(v, vy, vz):
        return [int(vz if vz is not None else v),
                int(vy if vy is not None else v), int(v)]

    out = helper.create_tmp_variable(iv.dtype, shape=None)
    helper.append_op(
        "pool3d", inputs={"X": [iv.name]}, outputs={"Out": [out.name]},
        attrs={"pooling_type": "avg" if pt in ("average", "avg") else "max",
               "ksize": _t3(pool_size, pool_size_y, pool_size_z),
               "strides": _t3(stride, stride_y, stride_z),
               "paddings": _t3(padding, padding_y, padding_z)})
    return _wrap(out, "pool3d", size=getattr(input, "size", None),
                 parents=[input], name=name)


# --- detection layers (ops in ops/detection_ops.py) -------------------------

def priorbox_layer(input, image, aspect_ratio, variance, min_size,
                   max_size=None, name=None):
    """PriorBoxLayer (reference layers.py priorbox_layer:1127, SSD)."""
    helper = LayerHelper("prior_box")
    iv, imv = _var(input), _var(image)
    boxes = helper.create_tmp_variable("float32", shape=None)
    variances = helper.create_tmp_variable("float32", shape=None)
    helper.append_op(
        "prior_box", inputs={"Input": [iv.name], "Image": [imv.name]},
        outputs={"Boxes": [boxes.name], "Variances": [variances.name]},
        attrs={"min_sizes": [float(s) for s in min_size],
               "max_sizes": [float(s) for s in (max_size or [])],
               "aspect_ratios": [float(a) for a in aspect_ratio],
               "variances": [float(v) for v in variance]})
    lo = _wrap(boxes, "priorbox", parents=[input, image], name=name)
    lo.outputs["variances"] = _wrap(variances, "priorbox_var")
    return lo


def multibox_loss_layer(input_loc, input_conf, priorbox, label, num_classes,
                        overlap_threshold=0.5, neg_pos_ratio=3.0,
                        neg_overlap=0.5, background_id=0, name=None):
    """MultiBoxLossLayer (reference layers.py multibox_loss_layer:1174)."""
    helper = LayerHelper("multibox_loss")
    locs = _vars(input_loc if isinstance(input_loc, (list, tuple))
                 else [input_loc])
    confs = _vars(input_conf if isinstance(input_conf, (list, tuple))
                  else [input_conf])
    loc = locs[0] if len(locs) == 1 else fl.concat(locs, axis=1)
    conf = confs[0] if len(confs) == 1 else fl.concat(confs, axis=1)
    loss = helper.create_tmp_variable("float32", shape=(1,))
    helper.append_op(
        "multibox_loss",
        inputs={"Loc": [loc.name], "Conf": [conf.name],
                "PriorBox": [_var(priorbox).name],
                "Label": [_var(label).name]},
        outputs={"Loss": [loss.name]},
        attrs={"num_classes": int(num_classes),
               "overlap_threshold": float(overlap_threshold),
               "neg_pos_ratio": float(neg_pos_ratio),
               "neg_overlap": float(neg_overlap),
               "background_id": int(background_id)})
    return _wrap(loss, "multibox_loss", size=1,
                 parents=[priorbox, label], name=name)


def detection_output_layer(input_loc, input_conf, priorbox, num_classes,
                           nms_threshold=0.45, nms_top_k=400, keep_top_k=200,
                           confidence_threshold=0.01, background_id=0,
                           name=None):
    """DetectionOutputLayer (reference layers.py detection_output_layer:1249)."""
    helper = LayerHelper("detection_output")
    locs = _vars(input_loc if isinstance(input_loc, (list, tuple))
                 else [input_loc])
    confs = _vars(input_conf if isinstance(input_conf, (list, tuple))
                  else [input_conf])
    loc = locs[0] if len(locs) == 1 else fl.concat(locs, axis=1)
    conf = confs[0] if len(confs) == 1 else fl.concat(confs, axis=1)
    out = helper.create_tmp_variable("float32", shape=None)
    helper.append_op(
        "detection_output",
        inputs={"Loc": [loc.name], "Conf": [conf.name],
                "PriorBox": [_var(priorbox).name], "PriorBoxVar": [""]},
        outputs={"Out": [out.name]},
        attrs={"num_classes": int(num_classes),
               "nms_threshold": float(nms_threshold),
               "nms_top_k": int(nms_top_k), "keep_top_k": int(keep_top_k),
               "score_threshold": float(confidence_threshold),
               "background_label": int(background_id)})
    return _wrap(out, "detection_output", parents=[priorbox], name=name)


def roi_pool_layer(input, rois, pooled_width, pooled_height, spatial_scale,
                   num_channels=None, name=None):
    """ROIPoolLayer (reference layers.py roi_pool_layer:1330)."""
    helper = LayerHelper("roi_pool")
    iv = _var(input)
    out = helper.create_tmp_variable(iv.dtype, shape=None)
    argmax = helper.create_tmp_variable("int32", shape=None)
    helper.append_op(
        "roi_pool", inputs={"X": [iv.name], "ROIs": [_var(rois).name]},
        outputs={"Out": [out.name], "Argmax": [argmax.name]},
        attrs={"pooled_height": int(pooled_height),
               "pooled_width": int(pooled_width),
               "spatial_scale": float(spatial_scale)})
    return _wrap(out, "roi_pool", parents=[input, rois], name=name)


# --- sequence slicing / selection -------------------------------------------

def seq_concat_layer(a, b, act=None, name=None, layer_attr=None,
                     bias_attr=None):
    """SequenceConcatLayer (reference layers.py seq_concat_layer:3533):
    concatenate two sequences along TIME per sample."""
    from ..layers.sequence import _set_length

    helper = LayerHelper("seq_concat")
    av, bv = _var(a), _var(b)
    la, lb = _get_length_strict(av), _get_length_strict(bv)
    out = helper.create_tmp_variable(av.dtype, shape=None)
    lout = helper.create_tmp_variable("int32", shape=None)
    helper.append_op(
        "sequence_concat_time",
        inputs={"X": [av.name, bv.name], "Length": [la.name, lb.name]},
        outputs={"Out": [out.name], "LengthOut": [lout.name]})
    _set_length(out, lout.name)
    out_lo = _wrap(_apply_act(out, act), "seqconcat",
                   size=getattr(a, "size", None), parents=[a, b], name=name)
    return out_lo


def sub_seq_layer(input, offsets, sizes, act=None, bias_attr=None, name=None):
    """SubSequenceLayer (reference layers.py sub_seq_layer:7361): per-sample
    [offset, offset+size) windows of each sequence."""
    from ..layers.sequence import _set_length

    helper = LayerHelper("sub_seq")
    iv = _var(input)
    out = helper.create_tmp_variable(iv.dtype, shape=None)
    lout = helper.create_tmp_variable("int32", shape=None)
    helper.append_op(
        "sequence_slice",
        inputs={"X": [iv.name], "Offset": [_var(offsets).name],
                "SliceLength": [_var(sizes).name]},
        outputs={"Out": [out.name], "LengthOut": [lout.name]})
    _set_length(out, lout.name)
    return _wrap(_apply_act(out, act), "subseq",
                 size=getattr(input, "size", None), parents=[input],
                 name=name)


def seq_slice_layer(input, starts, ends, name=None):
    """SeqSliceLayer (reference layers.py seq_slice_layer:7046): slice each
    sequence between per-sample start/end indices (None = begin/end)."""
    from ..layers.sequence import _set_length

    helper = LayerHelper("seq_slice")
    iv = _var(input)
    lv = _get_length_strict(iv)
    if starts is None:
        z = fl.fill_constant(shape=[1], dtype="int32", value=0)
        starts_v = fl.elementwise_mul(fl.cast(lv, "int32"), z, axis=0)
    else:
        starts_v = fl.reshape(_var(starts), [-1])
    if ends is None:
        ends_v = fl.cast(lv, "int32")
    else:
        ends_v = fl.reshape(_var(ends), [-1])
    sizes_v = fl.elementwise_sub(ends_v, starts_v)
    out = helper.create_tmp_variable(iv.dtype, shape=None)
    lout = helper.create_tmp_variable("int32", shape=None)
    helper.append_op(
        "sequence_slice",
        inputs={"X": [iv.name], "Offset": [starts_v.name],
                "SliceLength": [sizes_v.name]},
        outputs={"Out": [out.name], "LengthOut": [lout.name]})
    _set_length(out, lout.name)
    return _wrap(out, "seq_slice", size=getattr(input, "size", None),
                 parents=[input], name=name)


def kmax_seq_score_layer(input, name=None, beam_size=1):
    """KmaxSeqScoreLayer (reference layers.py kmax_seq_score_layer:7112):
    indices of the beam_size highest scores in each sequence."""
    helper = LayerHelper("kmax_seq_score")
    iv = _var(input)
    lv = _get_length_strict(iv)
    out = helper.create_tmp_variable("int64", shape=None)
    helper.append_op("kmax_seq_score",
                     inputs={"X": [iv.name], "Length": [lv.name]},
                     outputs={"Out": [out.name]},
                     attrs={"beam_size": int(beam_size)})
    return _wrap(out, "kmax_seq_score", size=getattr(input, "size", None),
                 parents=[input], name=name)


def sub_nested_seq_layer(input, selected_indices, name=None):
    """SubNestedSequenceLayer (reference layers.py sub_nested_seq_layer:6966):
    keep only the selected sub-sequences of a nested sequence (beam
    training).  Padded form: X [B,S,T,D] + per-sub lengths [B,S]."""
    from ..layers.sequence import _set_length

    helper = LayerHelper("sub_nested_seq")
    iv = _var(input)
    lv = _get_length_strict(iv)
    out = helper.create_tmp_variable(iv.dtype, shape=None)
    lout = helper.create_tmp_variable("int32", shape=None)
    helper.append_op(
        "sub_nested_seq",
        inputs={"X": [iv.name], "Length": [lv.name],
                "SelectedIndices": [_var(selected_indices).name]},
        outputs={"Out": [out.name], "LengthOut": [lout.name]})
    _set_length(out, lout.name)
    return _wrap(out, "sub_nested_seq", size=getattr(input, "size", None),
                 parents=[input, selected_indices], name=name)


def block_expand_layer(input, block_x=0, block_y=0, stride_x=0, stride_y=0,
                       padding_x=0, padding_y=0, num_channels=None, name=None,
                       layer_attr=None):
    """BlockExpandLayer (reference layers.py block_expand_layer:5358): im2col
    each CHW map into a sequence of outputH*outputW steps of
    block_y*block_x*C features (rides the im2sequence op, the fluid
    successor of this layer)."""
    helper = LayerHelper("block_expand")
    iv = _var(input)
    out = helper.create_tmp_variable(iv.dtype, shape=None)
    helper.append_op(
        "im2sequence", inputs={"X": [iv.name]},
        outputs={"Out": [out.name]},
        attrs={"kernels": [int(block_y), int(block_x)],
               "strides": [int(stride_y or 1), int(stride_x or 1)],
               "paddings": [int(padding_y), int(padding_x),
                            int(padding_y), int(padding_x)]})
    C = int(iv.shape[1]) if num_channels is None else int(num_channels)
    return _wrap(out, "blockexpand", size=int(block_x * block_y * C),
                 parents=[input], name=name)


# --- recurrent group machinery ----------------------------------------------

class StaticInput:
    """Read-only (non-scattered) input of recurrent_group (reference
    layers.py StaticInput:4051)."""

    def __init__(self, input, is_seq=False, size=None):
        self.input = input
        self.is_seq = is_seq


def SubsequenceInput(input):
    """Deprecated passthrough (reference layers.py SubsequenceInput:4066)."""
    return input


class BaseGeneratedInput:
    """Marker base for generation-driven recurrent-group inputs (reference
    layers.py BaseGeneratedInput:3986)."""


class GeneratedInput(BaseGeneratedInput):
    """Embedding of the previously generated token (reference layers.py
    GeneratedInput:4009): in beam_search, each step's selected words feed
    back through the shared `embedding_name` table of shape
    [size, embedding_size]."""

    def __init__(self, size, embedding_name, embedding_size):
        self.size = int(size)
        self.embedding_name = embedding_name
        self.embedding_size = int(embedding_size)


def memory(name, size, memory_name=None, is_seq=False, boot_layer=None,
           boot_bias=None, boot_bias_active_type=None,
           boot_with_const_id=None):
    """Previous-step output of the layer called `name` (reference layers.py
    memory:3590).  Must be used inside recurrent_group's step function; the
    recurrence closes when a layer with that name is built (see
    _register_name)."""
    if _rgroup is None:
        raise RuntimeError("memory() is only valid inside a recurrent_group "
                           "step function (RecurrentLayerGroup semantics)")
    key = name or memory_name
    init = _var(boot_layer) if boot_layer is not None else None
    mem_var = _rgroup.make_memory(key, init, int(size))
    _rgroup.pending[key] = mem_var
    lo = _wrap(mem_var, "memory", size=size)

    def set_input(layer):
        _register_name(key, _var(layer))

    lo.set_input = set_input
    return lo


def recurrent_group(step, input, reverse=False, name=None, targetInlink=None):
    """RecurrentLayerGroup (reference layers.py recurrent_group:4082;
    gserver RecurrentGradientMachine): scatter sequence inputs over time,
    trace `step` once into a StaticRNN sub-block (run step by step),
    memories close over named layers."""
    global _rgroup

    inputs = list(input) if isinstance(input, (list, tuple)) else [input]
    seq_ins = [i for i in inputs if isinstance(i, LayerOutput)]
    if not seq_ins:
        raise ValueError("recurrent_group needs at least one sequence input")
    outer = {}
    for i in seq_ins:
        v = _var(i)
        outer[id(i)] = fl.sequence_reverse(v) if reverse else v
    first = outer[id(seq_ins[0])]
    lengths = get_length_var(first)
    rnn = fl.StaticRNN(lengths=lengths)
    prev = _rgroup
    try:
        with rnn.step():
            args = []
            for i in inputs:
                if isinstance(i, LayerOutput):
                    inner = rnn.step_input(outer[id(i)])
                    args.append(_wrap(inner, "scatter", size=i.size))
                else:  # StaticInput: read the outer var inside the block
                    args.append(i.input)
            _rgroup = _RecurrentGroupCtx(rnn, batch_ref=first)
            outs = step(*args)
            out_list = list(outs) if isinstance(outs, (list, tuple)) \
                else [outs]
            for o in out_list:
                rnn.step_output(_var(o))
            if _rgroup.pending:
                missing = ", ".join(_rgroup.pending)
                raise RuntimeError(
                    f"recurrent_group: memories for [{missing}] were never "
                    f"bound — build a layer with that name (or call "
                    f"mem.set_input)")
    finally:
        _rgroup = prev
    res = rnn()
    res_list = res if isinstance(res, list) else [res]
    wrapped = []
    for o, r in zip(out_list, res_list):
        rv = fl.sequence_reverse(r) if reverse else r
        wrapped.append(_wrap(rv, "recurrent_group",
                             size=getattr(o, "size", None), name=name))
    return wrapped[0] if len(wrapped) == 1 else wrapped


def get_output_layer(input, arg_name, name=None, layer_attr=None):
    """GetOutputLayer (reference layers.py get_output_layer:3944): pick a
    named auxiliary output (e.g. lstm_step's 'state')."""
    aux = input.outputs.get(arg_name)
    if aux is None:
        raise ValueError(f"layer {input.name} has no output {arg_name!r} "
                         f"(has: {list(input.outputs)})")
    if name is not None:
        _register_name(name, _var(aux))
    return aux


def beam_search(step, input, bos_id, eos_id, beam_size, max_length=500,
                name=None, num_results_per_sample=None):
    """Generation-mode recurrent_group (reference layers.py beam_search:4465;
    RecurrentGradientMachine::generateSequence/beamSearch :307/:309).

    Instead of the reference's dynamic per-hypothesis
    scopes, the user's `step` function is traced ONCE into a While body over
    a beam-flattened batch [B*K, ...]; `memory()` calls become loop-carried
    vars gathered by parent pointers after each composable `beam_search` op
    step (ops/beam_ops.py), and `beam_search_decode` backtracks the
    hypotheses — the whole search is one While program.

    Returns a LayerOutput over the generated ids [B, K, L], with auxiliary
    outputs 'scores' [B, K] and 'lengths' [B, K] reachable via
    get_output_layer (v2's SequenceGenerator consumes exactly these)."""
    global _rgroup

    inputs = list(input) if isinstance(input, (list, tuple)) else [input]
    gens = [i for i in inputs if isinstance(i, BaseGeneratedInput)]
    if len(gens) != 1:
        raise ValueError("beam_search needs exactly one GeneratedInput "
                         "(the previously generated word feed)")
    gi = gens[0]
    statics = [i for i in inputs if isinstance(i, StaticInput)]
    if not statics:
        raise ValueError("beam_search needs at least one StaticInput (it "
                         "anchors the batch size at generation time)")
    stray = [i for i in inputs
             if not isinstance(i, (StaticInput, BaseGeneratedInput))]
    if stray:
        raise ValueError(
            f"beam_search inputs must be StaticInput or GeneratedInput "
            f"(reference layers.py beam_search:4465 'none of the input's "
            f"type should be LayerOutput'); got {stray}")
    K, L = int(beam_size), int(max_length)
    helper = LayerHelper("beam_search_group", name=name)
    program = default_main_program()
    ref = _var(statics[0].input)  # [B, ...]

    def batch_like(shape, value, dtype, out_idx=0):
        out = helper.create_tmp_variable(dtype, shape=tuple(shape),
                                         stop_gradient=True)
        helper.append_op(
            "fill_constant_batch_size_like",
            inputs={"Input": [ref.name]}, outputs={"Out": [out.name]},
            attrs={"shape": list(shape), "value": float(value),
                   "dtype": dtype, "input_dim_idx": 0,
                   "output_dim_idx": out_idx})
        return out

    def expand_beam(v, trailing):
        """[B, ...] -> [B*K, ...] (every hypothesis sees its sample's data)."""
        return _expand_lanes(program.current_block(), v, K, trailing)

    # --- pre-loop beam state -------------------------------------------------
    tokens = batch_like([-1, K], float(bos_id), "int64")
    # lane 0 live, the rest dead: K identical <bos> hypotheses would waste
    # the whole beam on copies
    lane = helper.create_tmp_variable("float32", shape=(1, K),
                                      stop_gradient=True)
    helper.append_op("assign_value", inputs={}, outputs={"Out": [lane.name]},
                     attrs={"shape": [1, K],
                            "fp32_values": [0.0] + [-1e9] * (K - 1)})
    scores = fl.elementwise_add(batch_like([-1, K], 0.0, "float32"), lane)
    ids_arr = batch_like([L, -1, K], 0.0, "int64", out_idx=1)
    par_arr = batch_like([L, -1, K], 0.0, "int32", out_idx=1)
    flat_ref = fl.reshape(tokens, [-1, 1])  # [B*K, 1] batch anchor

    expanded = {}
    for s in statics:
        v = _var(s.input)
        trailing = [int(d) for d in v.shape[1:]]
        ev = expand_beam(v, trailing)
        lv = get_length_var(v)
        if lv is not None:  # is_seq static input: replicate lengths too
            elv = expand_beam(lv, [])
            from ..layers.sequence import _set_length
            _set_length(ev, elv.name)
        expanded[id(s)] = _wrap(ev, "beam_static",
                                size=getattr(s.input, "size", None))

    t = fl.fill_constant(shape=[1], dtype="float32", value=0.0)
    n = fl.fill_constant(shape=[1], dtype="float32", value=float(L))
    ti = fl.fill_constant(shape=[1], dtype="int32", value=0)
    cond = fl.less_than(t, n)
    w = fl.While(cond)
    ctx = _BeamGroupCtx(program.current_block(), flat_ref.name, K)
    prev = _rgroup
    with w.block():
        try:
            _rgroup = ctx
            tok_flat = fl.reshape(tokens, [-1, 1])
            emb = fl.embedding(tok_flat, size=[gi.size, gi.embedding_size],
                               param_attr={"name": gi.embedding_name})
            args = []
            for i in inputs:
                if isinstance(i, BaseGeneratedInput):
                    args.append(_wrap(emb, "generated_input",
                                      size=gi.embedding_size))
                else:
                    args.append(expanded[id(i)])
            out = step(*args)
            out = out[0] if isinstance(out, (list, tuple)) else out
            if ctx.pending:
                missing = ", ".join(ctx.pending)
                raise RuntimeError(
                    f"beam_search: memories for [{missing}] were never "
                    f"bound — build a layer with that name inside step()")
        finally:
            _rgroup = prev
        V = int(out.size or gi.size)
        ov = fl.reshape(_var(out), [-1, V])
        if _needs_softmax(out):  # v1 step outputs are softmax-activated;
            ov = fl.softmax(ov)  # normalize the ones that aren't
        clipped = helper.create_tmp_variable(ov.dtype, shape=None,
                                             stop_gradient=True)
        helper.append_op("clip", inputs={"X": [ov.name]},
                         outputs={"Out": [clipped.name]},
                         attrs={"min": 1e-12, "max": 1.0})
        logp = helper.create_tmp_variable(ov.dtype, shape=None,
                                          stop_gradient=True)
        helper.append_op("log", inputs={"X": [clipped.name]},
                         outputs={"Out": [logp.name]})
        logp.shape = (-1, V)  # topk reads the static last dim
        cand_scores, cand_ids = fl.topk(logp, K)  # [B*K, K]
        sel_ids, sel_scores, parent = fl.beam_search(
            tokens, scores, fl.reshape(cand_ids, [-1, K, K]),
            fl.reshape(cand_scores, [-1, K, K]),
            beam_size=K, end_id=int(eos_id), is_accumulated=False)
        # re-lane every memory behind its surviving parent hypothesis
        for key, mem, size in ctx.mems:
            new = ctx.bound.get(key)
            if new is None:
                raise RuntimeError(f"beam_search: memory {key!r} has no "
                                   f"updated value")
            g = helper.create_tmp_variable(mem.dtype, shape=None,
                                           stop_gradient=True)
            helper.append_op(
                "beam_gather",
                inputs={"X": [fl.reshape(new, [-1, K, size]).name],
                        "Index": [parent.name]},
                outputs={"Out": [g.name]})
            fl.assign(fl.reshape(g, [-1, size]), mem)
        for arr, val, dt in ((ids_arr, sel_ids, "int64"),
                             (par_arr, parent, "int32")):
            wrote = helper.create_tmp_variable(dt, shape=None,
                                               stop_gradient=True)
            helper.append_op("array_write",
                             inputs={"Array": [arr.name], "X": [val.name],
                                     "I": [ti.name]},
                             outputs={"Out": [wrote.name]})
            fl.assign(wrote, arr)
        fl.assign(sel_ids, tokens)
        fl.assign(sel_scores, scores)
        fl.increment(t, 1.0)
        fl.increment(ti, 1)
        fl.less_than(t, n, cond=cond)

    sent, sscores, slen = fl.beam_search_decode(ids_arr, par_arr, scores,
                                                end_id=int(eos_id))
    nres = int(num_results_per_sample) if num_results_per_sample else K
    if nres < K:
        # beam lanes are score-sorted (each beam_search step is a top-k),
        # so the best n hypotheses are the first n lanes
        def lane_slice(v):
            out = helper.create_tmp_variable(v.dtype, shape=None,
                                             stop_gradient=True)
            helper.append_op("slice", inputs={"Input": [v.name]},
                             outputs={"Out": [out.name]},
                             attrs={"axes": [1], "starts": [0],
                                    "ends": [nres]})
            return out
        sent, sscores, slen = (lane_slice(sent), lane_slice(sscores),
                               lane_slice(slen))
    res = _wrap(sent, "beam_search", size=gi.size, name=name)
    res.outputs["scores"] = _wrap(sscores, "beam_scores", size=nres)
    res.outputs["lengths"] = _wrap(slen, "beam_lengths", size=nres)
    res.num_results_per_sample = nres
    return res


def lstm_step_layer(input, state, size=None, act=None, name=None,
                    gate_act=None, state_act=None, bias_attr=None,
                    layer_attr=None):
    """LstmStepLayer (reference layers.py lstm_step_layer:3686): one LSTM
    step over pre-projected input [B,4H] and cell state [B,H]; the cell
    output is exposed as aux output 'state'."""
    helper = LayerHelper("lstm_step")
    iv, sv = _var(input), _var(state)
    H = int(size) if size else int(sv.shape[-1])
    if bias_attr is not False and bias_attr is not None:
        b = helper.create_parameter(attr=to_param_attr(bias_attr) or {},
                                    shape=[4 * H], dtype=iv.dtype,
                                    is_bias=True)
        iv = fl.elementwise_add(iv, b)
    h = helper.create_tmp_variable(iv.dtype, shape=(iv.shape[0], H)
                                   if iv.shape else None)
    c = helper.create_tmp_variable(iv.dtype, shape=(iv.shape[0], H)
                                   if iv.shape else None)
    helper.append_op("lstm_unit",
                     inputs={"X": [iv.name], "C_prev": [sv.name]},
                     outputs={"H": [h.name], "C": [c.name]})
    lo = _wrap(h, "lstm_step", size=H, parents=[input, state], name=name)
    lo.outputs["state"] = _wrap(c, "lstm_state", size=H)
    return lo


def gru_step_layer(input, output_mem, size=None, bias_attr=None,
                   param_attr=None, act=None, name=None, gate_act=None,
                   layer_attr=None):
    """GruStepLayer (reference layers.py gru_step_layer:3784): one GRU step
    over pre-projected input [B,3H] and previous hidden [B,H]."""
    helper = LayerHelper("gru_step", param_attr=to_param_attr(param_attr))
    iv, hv = _var(input), _var(output_mem)
    H = int(size) if size else int(iv.shape[-1]) // 3
    w = helper.create_parameter(attr=to_param_attr(param_attr) or {},
                                shape=[H, 3 * H], dtype=iv.dtype)
    inputs = {"Input": [iv.name], "HiddenPrev": [hv.name],
              "Weight": [w.name]}
    if bias_attr is not False and bias_attr is not None:
        b = helper.create_parameter(attr=to_param_attr(bias_attr) or {},
                                    shape=[3 * H], dtype=iv.dtype,
                                    is_bias=True)
        inputs["Bias"] = [b.name]
    h = helper.create_tmp_variable(iv.dtype, shape=(iv.shape[0], H)
                                   if iv.shape else None)
    g = helper.create_tmp_variable(iv.dtype, shape=None)
    r = helper.create_tmp_variable(iv.dtype, shape=None)
    helper.append_op("gru_unit", inputs=inputs,
                     outputs={"Hidden": [h.name], "Gate": [g.name],
                              "ResetHiddenPrev": [r.name]})
    return _wrap(h, "gru_step", size=H, parents=[input, output_mem],
                 name=name)


def gru_step_naive_layer(input, output_mem, size=None, name=None, act=None,
                         gate_act=None, bias_attr=None, param_attr=None,
                         layer_attr=None):
    """gru_step_naive_layer (reference layers.py:3854) — same math as
    gru_step_layer built from primitives; one fused op here either way."""
    return gru_step_layer(input=input, output_mem=output_mem, size=size,
                          bias_attr=bias_attr, param_attr=param_attr,
                          act=act, name=name, gate_act=gate_act)


def recurrent_layer(input, act=None, bias_attr=None, param_attr=None,
                    name=None, reverse=False, layer_attr=None):
    """RecurrentLayer (reference layers.py recurrent_layer:3988): simple
    full-matrix recurrence out_t = act(x_t + out_{t-1} W + b)."""
    helper = LayerHelper("recurrent", param_attr=to_param_attr(param_attr))
    iv = _var(input)
    D = int(iv.shape[-1])
    w = helper.create_parameter(attr=to_param_attr(param_attr) or {},
                                shape=[D, D], dtype=iv.dtype)
    bias = None
    if bias_attr is not False:
        bias = helper.create_parameter(attr=to_param_attr(bias_attr) or {},
                                       shape=[D], dtype=iv.dtype,
                                       is_bias=True)
    a = act_name(act) or "tanh"
    seq = fl.sequence_reverse(iv) if reverse else iv
    rnn = fl.StaticRNN(lengths=get_length_var(seq))
    with rnn.step():
        x_t = rnn.step_input(seq)
        h_prev = rnn.memory(shape=[D], batch_ref=seq)
        hw = helper.create_tmp_variable(iv.dtype, shape=None)
        helper.block.program.current_block().append_op(
            "mul", inputs={"X": [h_prev.name], "Y": [w.name]},
            outputs={"Out": [hw.name]})
        z = fl.elementwise_add(x_t, hw)
        if bias is not None:
            z = fl.elementwise_add(z, bias)
        h = _apply_act(z, a)
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    out = rnn()
    if reverse:
        out = fl.sequence_reverse(out)
    return _wrap(out, "recurrent", size=D, parents=[input], name=name)
