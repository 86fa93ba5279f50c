"""The legacy v1 config API of the port against the JAX package's on the
CPU.

- Every builder of ``tests/test_v1_config_goldens.py`` (one per reference
  golden config), written once over a package namespace: each builds, in
  both packages, the same ``to_json`` (so the same op-type sequence in
  every block and the same parameter shapes), has its expected op types,
  and survives the port's ProgramDef round trip (``framework/proto_io``)
  with its op types unchanged.
- The v1 layers of ``tests/test_v1_layers_full.py`` and
  ``tests/test_v1_api.py`` (all but ``sampling_id_layer``, which draws),
  built by the same code in both packages: the JAX startup's values
  carried into the port by name, the same numpy feeds, every fetch within
  1e-5 (relative to its max |value|; integer outputs exact)."""

from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
import paddle_tpu.v1 as j_v1_pkg
import paddle_tpu_torch.v1 as t_v1_pkg
from paddle_tpu import lod as j_lod
from paddle_tpu.layers.sequence import _set_length as j_set_length
from paddle_tpu.v1 import activations as j_act
from paddle_tpu.v1 import layers as j_v1
from paddle_tpu.v1 import networks as j_nets
from paddle_tpu_torch import lod as t_lod
from paddle_tpu_torch.framework import proto_io as t_proto_io
from paddle_tpu_torch.layers.sequence import _set_length as t_set_length
from paddle_tpu_torch.v1 import activations as t_act
from paddle_tpu_torch.v1 import layers as t_v1
from paddle_tpu_torch.v1 import networks as t_nets

PKG = {
    "jax": SimpleNamespace(fluid=jfluid, v1=j_v1, nets=j_nets, act=j_act,
                           set_length=j_set_length, lod=j_lod,
                           v1_pkg=j_v1_pkg),
    "port": SimpleNamespace(fluid=tfluid, v1=t_v1, nets=t_nets, act=t_act,
                            set_length=t_set_length, lod=t_lod,
                            v1_pkg=t_v1_pkg),
}
TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh():
    tfluid.reset()
    jfluid.reset()
    yield


# --- the golden builders, over a package namespace `p` ----------------------

def _seq(v1, name, size, dtype="float32"):
    return v1.data_layer(name, size=size, dtype=dtype, seq=True)


def _img(v1, name, c, h, w):
    return v1.data_layer(name, size=c * h * w, height=h, width=w)


# --- one builder per reference config file ---------------------------------

def cfg_img_layers(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    img = _img(v1, "image", 1, 16, 16)
    conv = v1.img_conv_layer(img, filter_size=3, num_filters=4, padding=1,
                             act=p.act.ReluActivation())
    bn = v1.batch_norm_layer(conv, act=p.act.ReluActivation())
    pool = v1.img_pool_layer(bn, pool_size=2, stride=2)
    norm = v1.img_cmrnorm_layer(pool, size=5)
    return norm, {"conv2d", "batch_norm", "pool2d", "lrn"}


def cfg_img_trans_layers(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    img = _img(v1, "timage", 4, 8, 8)
    convt = v1.img_conv_layer(img, filter_size=3, num_filters=2, stride=2,
                              trans=True)
    return convt, {"conv2d_transpose"}


def cfg_last_first_seq(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    s = _seq(v1, "lfseq", 6)
    a = v1.first_seq(s)
    b = v1.last_seq(s)
    return v1.concat_layer([a, b]), {"sequence_pool", "concat"}


def cfg_layer_activations(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    x = v1.data_layer("actx", size=8)
    outs = []
    for act in (p.act.TanhActivation(), p.act.SigmoidActivation(),
                p.act.ReluActivation(), p.act.SoftmaxActivation()):
        outs.append(v1.fc_layer(x, size=4, act=act))
    return v1.addto_layer(outs), {"tanh", "sigmoid", "relu", "softmax"}


def cfg_math_ops(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    x = v1.data_layer("mx", size=4)
    y = v1.slope_intercept_layer(x, slope=2.0, intercept=1.0)
    z = v1.power_layer(y, v1.data_layer("mw", size=1))
    c = v1.clip_layer(z, min=-5.0, max=5.0)
    return c, {"scale", "elementwise_pow", "clip"}


def cfg_projections(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    a = v1.data_layer("pja", size=6)
    ids = v1.data_layer("pjids", size=10, dtype="int64")
    m = v1.mixed_layer(size=6, input=[
        v1.full_matrix_projection(a, size=6),
        v1.identity_projection(a),
        v1.table_projection(ids, size=6),
        v1.dotmul_projection(a),
    ], act=p.act.TanhActivation())
    return m, {"mul", "lookup_table", "elementwise_mul", "tanh"}


def cfg_shared_fc(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    a = v1.data_layer("sfa", size=4)
    b = v1.data_layer("sfb", size=4)
    fa = v1.fc_layer(a, size=3)
    fb = v1.fc_layer(b, size=3)
    return v1.addto_layer([fa, fb]), {"mul", "elementwise_add"}


def cfg_shared_gru(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    s = _seq(v1, "sgru", 6)
    g1 = v1nets.simple_gru(s, size=4)
    return v1.last_seq(g1), {"gru"}


def cfg_shared_lstm(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    s = _seq(v1, "slstm", 6)
    l1 = v1nets.simple_lstm(s, size=4)
    return v1.last_seq(l1), {"lstm"}


def cfg_simple_rnn_layers(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    s = _seq(v1, "srl", 8)
    r = v1.recurrent_layer(s, act=p.act.TanhActivation())
    proj4 = v1.fc_layer(s, size=32, bias_attr=False)
    l = v1.lstmemory(proj4, size=8)
    proj3 = v1.fc_layer(s, size=24, bias_attr=False)
    g = v1.grumemory(proj3, size=8, reverse=True)
    return v1.addto_layer([v1.last_seq(r), v1.last_seq(l), v1.last_seq(g)]), \
        {"static_rnn", "lstm", "gru", "sequence_reverse"}


def cfg_test_BatchNorm3D(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    vol = fluid.layers.data("bn3vol", shape=[2, 4, 4, 4], dtype="float32")
    lo = v1.LayerOutput(vol, "data", size=128)
    bn = v1.batch_norm_layer(lo)
    return bn, {"batch_norm"}


def cfg_test_bi_grumemory(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    s = _seq(v1, "bigru", 6)
    return v1nets.bidirectional_gru(s, size=4), {"gru", "sequence_reverse"}


def cfg_test_bilinear_interp(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    img = _img(v1, "bili", 2, 4, 4)
    conv = v1.img_conv_layer(img, filter_size=3, num_filters=2, padding=1)
    up = v1.bilinear_interp_layer(conv, out_size_x=8, out_size_y=8)
    return up, {"bilinear_interp"}


def cfg_test_clip_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    x = v1.data_layer("clx", size=4)
    return v1.clip_layer(x, min=-1.0, max=1.0), {"clip"}


def cfg_test_conv3d_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    vol = fluid.layers.data("c3vol", shape=[1, 4, 4, 4], dtype="float32")
    lo = v1.LayerOutput(vol, "data", size=64)
    return v1.img_conv3d_layer(lo, filter_size=3, num_filters=2, padding=1), \
        {"conv3d"}


def cfg_test_deconv3d_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    vol = fluid.layers.data("d3vol", shape=[2, 4, 4, 4], dtype="float32")
    lo = v1.LayerOutput(vol, "data", size=128)
    return v1.img_conv3d_layer(lo, filter_size=2, num_filters=1, stride=2,
                               trans=True), {"conv3d_transpose"}


def cfg_test_cost_layers(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    score = v1.data_layer("cs_sc", size=1)
    left = v1.data_layer("cs_l", size=1)
    right = v1.data_layer("cs_r", size=1)
    lab01 = v1.data_layer("cs_lab", size=1)
    probs = v1.fc_layer(v1.data_layer("cs_x", size=6), size=4,
                        act=p.act.SoftmaxActivation())
    ilab = v1.data_layer("cs_il", size=1, dtype="int64")
    costs = [
        v1.classification_cost(probs, ilab),
        v1.cross_entropy(probs, ilab),
        v1.cross_entropy_with_selfnorm(probs, ilab),
        v1.huber_regression_cost(score, lab01),
        v1.huber_classification_cost(score, lab01),
        v1.rank_cost(left, right, lab01),
        v1.multi_binary_label_cross_entropy(
            v1.fc_layer(probs, size=4), v1.data_layer("cs_ml", size=4)),
        v1.sum_cost(score),
        v1.smooth_l1_cost(score, lab01),
    ]
    return v1.addto_layer(costs), {
        "cross_entropy", "cross_entropy_selfnorm", "huber_loss",
        "huber_classification", "rank_loss",
        "sigmoid_cross_entropy_with_logits", "reduce_sum", "smooth_l1_loss"}


def cfg_test_cost_layers_with_weight(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    x = v1.fc_layer(v1.data_layer("cw_x", size=4), size=2,
                    act=p.act.SoftmaxActivation())
    lab = v1.data_layer("cw_l", size=1, dtype="int64")
    return v1.classification_cost(x, lab), {"cross_entropy", "mean"}


def cfg_test_crop(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    img = _img(v1, "crimg", 1, 8, 8)
    pad = v1.pad_layer(img, pad_h=[1, 1], pad_w=[1, 1])
    return v1.crop_layer(pad, offset=[1, 1], shape=[8, 8]), {"pad", "crop"}


def cfg_test_detection_output_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    feat = _img(v1, "do_f", 4, 4, 4)
    img = _img(v1, "do_i", 3, 16, 16)
    pb = v1.priorbox_layer(feat, img, aspect_ratio=[2.0],
                           variance=[0.1, 0.1, 0.2, 0.2], min_size=[4.0])
    loc = v1.data_layer("do_loc", size=4)
    conf = v1.data_layer("do_conf", size=8)
    return v1.detection_output_layer(loc, conf, pb, num_classes=2), \
        {"prior_box", "detection_output"}


def cfg_test_multibox_loss_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    feat = _img(v1, "mb_f", 4, 4, 4)
    img = _img(v1, "mb_i", 3, 16, 16)
    pb = v1.priorbox_layer(feat, img, aspect_ratio=[2.0],
                           variance=[0.1, 0.1, 0.2, 0.2], min_size=[4.0])
    loc = v1.data_layer("mb_loc", size=4)
    conf = v1.data_layer("mb_conf", size=8)
    lab = v1.data_layer("mb_lab", size=6)
    return v1.multibox_loss_layer(loc, conf, pb, lab, num_classes=2), \
        {"prior_box", "multibox_loss"}


def cfg_test_dot_prod_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    a = v1.data_layer("dpa", size=4)
    b = v1.data_layer("dpb", size=4)
    return v1.dot_prod_layer(a, b), {"elementwise_mul", "reduce_sum"}


def cfg_test_expand_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    d = v1.data_layer("exd", size=4)
    s = _seq(v1, "exs", 4)
    return v1.expand_layer(d, s), {"sequence_expand"}


def cfg_test_factorization_machine(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    x = v1.data_layer("fmx", size=8)
    return v1.factorization_machine(x, factor_size=3), \
        {"factorization_machine"}


def cfg_test_fc(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    x = v1.data_layer("fcx", size=8)
    h = v1.fc_layer(x, size=4, act=p.act.TanhActivation())
    return v1.fc_layer(h, size=2), {"mul", "tanh"}


def cfg_test_gated_unit_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    x = v1.data_layer("gux2", size=6)
    return v1.gated_unit_layer(x, size=3), {"sigmoid", "elementwise_mul"}


def cfg_test_grumemory_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    s = _seq(v1, "grml", 6)
    proj = v1.fc_layer(s, size=12, bias_attr=False)
    return v1.grumemory(proj, size=4), {"gru"}


def cfg_test_hsigmoid(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    x = v1.data_layer("hsx", size=8)
    lab = v1.data_layer("hsl", size=1, dtype="int64")
    return v1.hsigmoid(x, lab, num_classes=6), {"hsigmoid"}


def cfg_test_kmax_seq_socre_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    s = _seq(v1, "kmx", 1)
    return v1.kmax_seq_score_layer(s, beam_size=3), {"kmax_seq_score"}


def cfg_test_l2_distance_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    a = v1.data_layer("l2a", size=5)
    b = v1.data_layer("l2b", size=5)
    return v1.l2_distance_layer(a, b), {"squared_l2_distance", "sqrt"}


def cfg_test_lstmemory_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    s = _seq(v1, "lml", 4)
    proj = v1.fc_layer(s, size=16, bias_attr=False)
    return v1.lstmemory(proj, size=4, reverse=True), \
        {"lstm", "sequence_reverse"}


def cfg_test_maxout(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    img = _img(v1, "moimg", 8, 4, 4)
    conv = v1.img_conv_layer(img, filter_size=3, num_filters=8, padding=1)
    return v1.maxout_layer(conv, groups=2), {"maxout"}


def cfg_test_multiplex_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    ids = v1.data_layer("mpid", size=1, dtype="int64")
    a = v1.data_layer("mpa", size=4)
    b = v1.data_layer("mpb", size=4)
    c = v1.data_layer("mpc", size=4)
    return v1.multiplex_layer([ids, a, b, c]), {"multiplex"}


def cfg_test_ntm_layers(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    w = v1.data_layer("ntw", size=1)
    a = v1.data_layer("nta", size=6)
    b = v1.data_layer("ntb", size=6)
    t = v1.tensor_layer(a, b, size=4)
    cs = v1.cos_sim(a, b)
    conv = v1.conv_shift_layer(a, v1.data_layer("ntc", size=3))
    interp = v1.interpolation_layer([a, b], w)
    return v1.addto_layer([v1.fc_layer(t, size=6), v1.fc_layer(cs, size=6),
                           v1.fc_layer(conv, size=6), interp]), \
        {"bilinear_tensor_product", "cos_sim", "conv_shift"}


def cfg_test_pad(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    img = _img(v1, "pdimg", 2, 4, 4)
    return v1.pad_layer(img, pad_c=[1, 1], pad_h=[0, 0], pad_w=[2, 2]), \
        {"pad"}


def cfg_test_pooling3D_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    vol = fluid.layers.data("p3vol", shape=[2, 4, 4, 4], dtype="float32")
    lo = v1.LayerOutput(vol, "data", size=128)
    return v1.img_pool3d_layer(lo, pool_size=2, stride=2), {"pool3d"}


def cfg_test_prelu_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    img = _img(v1, "prlimg", 3, 4, 4)
    return v1.prelu_layer(img), {"prelu"}


def cfg_test_print_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    x = v1.data_layer("prx2", size=4)
    return v1.printer_layer(x), {"print"}


def cfg_test_recursive_topology(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    x = v1.data_layer("rtx", size=4)
    out = x
    for _ in range(8):
        out = v1.addto_layer([out, out])
    return out, {"elementwise_add"}


def cfg_test_repeat_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    x = v1.data_layer("rpx", size=4)
    a = v1.repeat_layer(x, 2, as_row_vector=True)
    b = v1.repeat_layer(x, 2, as_row_vector=False)
    return v1.concat_layer([a, b]), {"concat", "expand"}


def cfg_test_resize_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    x = v1.data_layer("rsx", size=16)
    return v1.resize_layer(x, size=4), {"reshape"}


def cfg_test_rnn_group(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    s = _seq(v1, "rgs", 4)

    def step(x_t):
        mem = v1.memory(name="rg_h", size=4)
        return v1.fc_layer([x_t, mem], size=4, act=p.act.TanhActivation(),
                           name="rg_h")

    out = v1.recurrent_group(step=step, input=s)
    return v1.last_seq(out), {"static_rnn"}


def cfg_test_roi_pool_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    img = _img(v1, "rpimg", 4, 8, 8)
    rois = v1.data_layer("rprois", size=5)
    conv = v1.img_conv_layer(img, filter_size=3, num_filters=4, padding=1)
    return v1.roi_pool_layer(conv, rois, pooled_width=2, pooled_height=2,
                             spatial_scale=0.5), {"roi_pool"}


def cfg_test_row_conv(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    s = _seq(v1, "rcs", 6)
    return v1.row_conv_layer(s, context_len=2), {"row_conv"}


def cfg_test_row_l2_norm_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    x = v1.data_layer("rlnx", size=6)
    return v1.row_l2_norm_layer(x), {"norm"}


def cfg_test_scale_shift_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    x = v1.data_layer("sshx", size=4)
    return v1.scale_shift_layer(x), {"elementwise_mul", "elementwise_add"}


def cfg_test_scale_sub_region_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    img = _img(v1, "ssrimg", 2, 4, 4)
    idx = v1.data_layer("ssridx", size=6)
    return v1.scale_sub_region_layer(img, idx, value=2.0), \
        {"scale_sub_region"}


def cfg_test_seq_concat_reshape(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    a = _seq(v1, "scra", 4)
    b = _seq(v1, "scrb", 4)
    cc = v1.seq_concat_layer(a, b)
    return v1.seq_reshape_layer(cc, reshape_size=2), \
        {"sequence_concat_time", "sequence_reshape"}


def cfg_test_seq_slice_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    s = _seq(v1, "ssls", 1)
    st = v1.data_layer("sslst", size=1, dtype="int64")
    en = v1.data_layer("sslen", size=1, dtype="int64")
    return v1.seq_slice_layer(s, st, en), {"sequence_slice"}


def cfg_test_sequence_pooling(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    s = _seq(v1, "sqp", 6)
    outs = [v1.pooling_layer(s, pooling_type=pt)
            for pt in (v1.MaxPooling(), v1.AvgPooling())]
    return v1.concat_layer(outs), {"sequence_pool"}


def cfg_test_smooth_l1(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    x = v1.data_layer("smx", size=4)
    y = v1.data_layer("smy", size=4)
    return v1.smooth_l1_cost(x, y), {"smooth_l1_loss"}


def cfg_test_split_datasource(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    # data-config-only golden in the reference; the graph side is one input
    return v1.fc_layer(v1.data_layer("sdx", size=4), size=2), {"mul"}


def cfg_test_spp_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    img = _img(v1, "sppimg", 2, 8, 8)
    return v1.spp_layer(img, pyramid_height=2), {"spp"}


def cfg_test_sub_nested_seq_select_layer(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    x = fluid.layers.data("snsx", shape=[3, 2, 2], dtype="float32")
    fluid.layers.data("snsl", shape=[3], dtype="int32")
    p.set_length(x, "snsl")
    lo = v1.LayerOutput(x, "data", size=2)
    sel = v1.data_layer("snsel", size=2, dtype="int64")
    return v1.sub_nested_seq_layer(lo, sel), {"sub_nested_seq"}


def cfg_unused_layers(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    p = v1.fc_layer(v1.data_layer("ulx", size=4), size=3,
                    act=p.act.SoftmaxActivation())
    sid = v1.sampling_id_layer(p)
    return v1.eos_layer(sid, eos_id=2), {"sampling_id", "equal"}


def cfg_util_layers(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    a = v1.data_layer("uta", size=4)
    b = v1.data_layer("utb", size=4)
    s = v1.addto_layer([a, b])
    c = v1.concat_layer([a, b])
    t = v1.trans_layer(v1.data_layer("utt", size=4))
    return v1.addto_layer([v1.fc_layer(s, size=2), v1.fc_layer(c, size=2)]), \
        {"elementwise_add", "concat", "transpose"}


def cfg_test_lambda_cost(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    s = _seq(v1, "lcs", 1)
    sc = _seq(v1, "lcsc", 1)
    return v1.lambda_cost(s, sc, NDCG_num=3), {"lambda_rank"}


def cfg_test_cross_entropy_over_beam(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    # mirrors the reference's three-expansion beam QA config: kmax beam
    # expansions scored by fc, cost summed over beams
    scores = _seq(v1, "ceob_scores", 1)
    topk = v1.kmax_seq_score_layer(scores, beam_size=3)
    gold = v1.data_layer("ceob_gold", size=1, dtype="int64")
    feats = _seq(v1, "ceob_feats", 4)
    s2 = v1.fc_layer(feats, size=1, act=None)
    topk2 = v1.kmax_seq_score_layer(s2, beam_size=3)
    gold2 = v1.data_layer("ceob_gold2", size=1, dtype="int64")
    cost = v1.cross_entropy_over_beam([
        v1.BeamInput(candidate_scores=scores, selected_candidates=topk,
                     gold=gold),
        v1.BeamInput(candidate_scores=s2, selected_candidates=topk2,
                     gold=gold2)])
    return cost, {"kmax_seq_score", "cross_entropy_over_beam"}


def cfg_test_config_parser_for_non_file_config(p):
    v1, v1nets, fluid = p.v1, p.nets, p.fluid
    # the reference feeds a config FUNCTION (not a file) through
    # parse_config; parse_network accepts the same callable form
    holder = {}

    def configs():
        x = v1.data_layer("nfc_x", size=4)
        holder["out"] = v1.fc_layer(x, size=2, act=p.act.SoftmaxActivation())

    prog = v1.parse_network(configs)
    return holder["out"], {"softmax"}




CONFIGS = [v for k, v in sorted(globals().items()) if k.startswith("cfg_")]


def _op_types(prog):
    return [[op.type for op in b.ops] for b in prog.blocks]


@pytest.mark.parametrize("builder", CONFIGS,
                         ids=[f.__name__[4:] for f in CONFIGS])
def test_config_golden_matches_jax(builder):
    jfluid.reset()
    j_out, expected = builder(PKG["jax"])
    j_prog = j_v1.parse_network(j_out)
    tfluid.reset()
    t_out, expected_t = builder(PKG["port"])
    t_prog = t_v1.parse_network(t_out)
    assert expected_t == expected
    assert _op_types(t_prog) == _op_types(j_prog)
    assert t_prog.to_json() == j_prog.to_json()
    assert not expected - {t for b in _op_types(t_prog) for t in b}
    t_params = {p.name: tuple(p.shape)
                for p in t_prog.global_block().all_parameters()}
    j_params = {p.name: tuple(p.shape)
                for p in j_prog.global_block().all_parameters()}
    assert t_params == j_params
    back = t_proto_io.parse_program(t_proto_io.serialize_program(t_prog))
    assert _op_types(back) == _op_types(t_prog)


# --- the v1 layers run: the port against JAX from the same state ------------

def _seqs(p, name, seqs):
    return {name: p.lod.LoDTensor.from_sequences(seqs)}


def _rand(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def lay_resize_switch_order_costs(p):
    v1, act = p.v1, p.act
    img = v1.data_layer("ri", size=12, height=2, width=3)
    x = v1.data_layer("cx", size=6)
    probs = v1.fc_layer(x, size=4, act=act.SoftmaxActivation())
    lab = v1.data_layer("cl", size=1, dtype="int64")
    y = v1.data_layer("cy", size=4)
    outs = [v1.switch_order_layer(img, reshape_axis=3),
            v1.resize_layer(img, size=6), v1.classification_cost(probs, lab),
            v1.mse_cost(probs, y), v1.sum_cost(probs)]
    return outs, {"ri": _rand(1, 2, 2, 2, 3), "cx": _rand(0, 3, 6),
                  "cl": np.array([[1], [3], [0]], np.int64),
                  "cy": _rand(2, 3, 4)}


def lay_sum_to_one_and_products(p):
    v1 = p.v1
    a = v1.data_layer("pa", size=3)
    b = v1.data_layer("pb", size=3)
    w = v1.data_layer("lw", size=2)
    vec = v1.data_layer("lv", size=6)
    outs = [v1.sum_to_one_norm_layer(a), v1.dot_prod_layer(a, b),
            v1.out_prod_layer(a, b),
            v1.linear_comb_layer(weights=w, vectors=vec, size=3),
            v1.scale_shift_layer(a)]
    return outs, {"pa": _rand(2, 2, 3) + 0.1, "pb": _rand(3, 2, 3),
                  "lw": _rand(4, 2, 2), "lv": _rand(5, 2, 6)}


def lay_image_layers(p):
    v1, act = p.v1, p.act
    img = v1.data_layer("im", size=2 * 6 * 6, height=6, width=6)
    conv = v1.img_conv_layer(img, filter_size=3, num_filters=4, padding=1,
                             act=act.ReluActivation())
    pool = v1.img_pool_layer(conv, pool_size=2, stride=2)
    outs = [conv, pool, v1.img_cmrnorm_layer(pool, size=3),
            v1.block_expand_layer(img, block_x=2, block_y=3, stride_x=2,
                                  stride_y=1, padding_x=1, padding_y=0)]
    return outs, {"im": _rand(6, 2, 2, 6, 6)}


def lay_detection_wrappers(p):
    v1 = p.v1
    feat = v1.data_layer("dfeat", size=4 * 2 * 2, height=2, width=2)
    img = v1.data_layer("dimg", size=3 * 8 * 8, height=8, width=8)
    pb = v1.priorbox_layer(feat, img, aspect_ratio=[2.0],
                           variance=[0.1, 0.1, 0.2, 0.2],
                           min_size=[4.0], max_size=[6.0])
    rois = v1.data_layer("drois", size=5)
    rp = v1.roi_pool_layer(feat, rois, pooled_width=2, pooled_height=2,
                           spatial_scale=0.25)
    return [pb, rp], {"dfeat": _rand(7, 2, 4, 2, 2),
                      "dimg": _rand(8, 2, 3, 8, 8),
                      "drois": np.array([[0, 0, 0, 4, 4], [1, 2, 0, 7, 6]],
                                        np.float32)}


def lay_sequence_slicing(p):
    v1 = p.v1
    a = v1.data_layer("sca", size=2, seq=True)
    b = v1.data_layer("scb", size=2, seq=True)
    cc = v1.seq_concat_layer(a, b)
    x = v1.data_layer("ssq", size=1, seq=True)
    sub = v1.sub_seq_layer(x, v1.data_layer("soff", size=1, dtype="int64"),
                           v1.data_layer("ssz", size=1, dtype="int64"))
    km = v1.kmax_seq_score_layer(x, beam_size=2)
    feeds = {}
    feeds.update(_seqs(p, "sca", [_rand(9, 2, 2), _rand(10, 3, 2)]))
    feeds.update(_seqs(p, "scb", [_rand(11, 1, 2), _rand(12, 2, 2)]))
    feeds.update(_seqs(p, "ssq", [_rand(13, 4, 1), _rand(14, 3, 1)]))
    feeds["soff"] = np.array([[1], [0]], np.int64)
    feeds["ssz"] = np.array([[2], [3]], np.int64)
    return [cc, v1.last_seq(cc), v1.last_seq(sub), km], feeds


def lay_sub_nested_seq(p):
    v1 = p.v1
    x = p.fluid.layers.data("nsx", shape=[3, 2, 1], dtype="float32")
    p.fluid.layers.data("nsl", shape=[3], dtype="int32")
    p.set_length(x, "nsl")
    sub = v1.sub_nested_seq_layer(v1.LayerOutput(x, "data", size=1),
                                  v1.data_layer("nsel", size=2,
                                                dtype="int64"))
    return [sub], {"nsx": np.arange(6, dtype=np.float32).reshape(1, 3, 2, 1),
                   "nsl": np.array([[2, 2, 2]], np.int32),
                   "nsel": np.array([[2, 0]], np.int64)}


def lay_recurrent_groups(p):
    v1 = p.v1
    x = v1.data_layer("rgx", size=1, seq=True)
    bias = v1.data_layer("rrb", size=1)

    def step(x_t):
        mem = v1.memory(name="acc", size=1)
        return v1.addto_layer([x_t, mem], name="acc")

    def step_rev(x_t, b):
        mem = v1.memory(name="acc2", size=1)
        s = v1.addto_layer([x_t, mem], name="acc2")
        return v1.addto_layer([s, b])

    fwd = v1.recurrent_group(step=step, input=x)
    rev = v1.recurrent_group(step=step_rev,
                             input=[x, v1.StaticInput(bias)], reverse=True)
    r = v1.data_layer("rlx", size=2, seq=True)
    rnn = v1.recurrent_layer(r, act=v1.LinearActivation(), bias_attr=False)
    feeds = _seqs(p, "rgx", [_rand(15, 3, 1), _rand(16, 2, 1)])
    feeds.update(_seqs(p, "rlx", [_rand(17, 2, 2), _rand(18, 3, 2)]))
    feeds["rrb"] = _rand(19, 2, 1)
    return [v1.last_seq(fwd), v1.first_seq(rev), v1.last_seq(rnn)], feeds


def lay_gated_row_conv_gru_group(p):
    v1 = p.v1
    from_nets = p.nets
    x = v1.data_layer("gux", size=4)
    s = v1.data_layer("rcx", size=2, seq=True)
    g = v1.data_layer("ggx", size=2, seq=True)
    gru = from_nets.gru_group(v1.fc_layer(g, size=6, bias_attr=False),
                              size=2, name="gg")
    outs = [v1.gated_unit_layer(x, size=3),
            v1.row_conv_layer(s, context_len=2), v1.last_seq(gru)]
    feeds = {"gux": _rand(20, 2, 4)}
    feeds.update(_seqs(p, "rcx", [_rand(21, 3, 2), _rand(22, 3, 2)]))
    feeds.update(_seqs(p, "ggx", [_rand(23, 3, 2), _rand(24, 2, 2)]))
    return outs, feeds


def lay_projections_and_operators(p):
    v1 = p.v1
    x = v1.data_layer("pmx", size=4)
    y = v1.data_layer("pmy", size=4)
    with v1.mixed_layer(size=4) as m:
        m += v1.trans_full_matrix_projection(x, size=4)
        m += v1.scaling_projection(x)
        m += v1.slice_projection(x, slices=[(0, 2), (2, 4)])
        m += v1.dotmul_operator(a=x, b=y, scale=2.0)
    img = v1.data_layer("cpi", size=16, height=4, width=4)
    with v1.mixed_layer() as m1:
        m1 += v1.conv_projection(img, filter_size=3, num_filters=2,
                                 padding=1)
    filt = v1.data_layer("cpf", size=18)
    with v1.mixed_layer() as m2:
        m2 += v1.conv_operator(img=img, filter=filt, filter_size=3,
                               num_filters=2, num_channels=1, padding=1)
    return [m, m1, m2], {"pmx": _rand(25, 2, 4), "pmy": _rand(26, 2, 4),
                         "cpi": _rand(27, 2, 1, 4, 4),
                         "cpf": _rand(28, 2, 18)}


def lay_lstmemory_group_adam_steps(p):
    """Three Adam steps: the fetched loss of each and the step-1 output."""
    v1 = p.v1
    p.v1_pkg.settings(learning_rate=5e-2,
                      learning_method=p.v1_pkg.AdamOptimizer())
    x = v1.data_layer("lgx", size=3, seq=True)
    proj = v1.fc_layer(x, size=16, bias_attr=False)
    h = p.nets.lstmemory_group(proj, size=4, name="lg")
    pooled = v1.pooling_layer(h, pooling_type=v1.MaxPooling)
    cost = v1.mse_cost(v1.fc_layer(pooled, size=1),
                       v1.data_layer("lgy", size=1))
    p.v1_pkg.optimizer_from_settings().minimize(cost.var)
    rng = np.random.RandomState(0)
    seqs = [rng.randn(n, 3).astype(np.float32) for n in (4, 2, 3, 4)]
    feeds = _seqs(p, "lgx", seqs)
    feeds["lgy"] = np.array([[s.sum() > 0] for s in seqs], np.float32)
    return [cost, pooled], feeds


def lay_image_reshaping_and_norms(p):
    """pad, crop, reverse (rotate), bilinear_interp, maxout, prelu and the
    SSD norm with its scale."""
    v1, act = p.v1, p.act
    img = v1.data_layer("irimg", size=2 * 4 * 4, height=4, width=4)
    padded = v1.pad_layer(img, pad_c=[1, 0], pad_h=[1, 1], pad_w=[0, 2])
    conv = v1.img_conv_layer(img, filter_size=3, num_filters=4, padding=1,
                             act=act.ReluActivation())
    outs = [padded,
            v1.crop_layer(padded, offset=[1, 1], shape=[4, 4], axis=2),
            v1.rotate_layer(img, height=4, width=4),
            v1.bilinear_interp_layer(conv, out_size_x=7, out_size_y=5),
            v1.maxout_layer(conv, groups=2), v1.prelu_layer(img),
            v1.cross_channel_norm_layer(img)]
    x = _rand(40, 3, 2, 4, 4) - 0.5
    x[0, 0, 0, :2] = 0.0
    return outs, {"irimg": x}


def lay_pyramid_and_volumes(p):
    """spp, conv3d, conv3d_transpose and pool3d."""
    v1 = p.v1
    img = v1.data_layer("pvimg", size=2 * 5 * 6, height=5, width=6)
    vol = p.fluid.layers.data("pvvol", shape=[2, 4, 4, 4], dtype="float32")
    lo = v1.LayerOutput(vol, "data", size=128)
    c3 = v1.img_conv3d_layer(lo, filter_size=3, num_filters=3, padding=1)
    outs = [v1.spp_layer(img, pyramid_height=3), c3,
            v1.img_conv3d_layer(c3, filter_size=2, num_filters=2, stride=2,
                                num_channels=3, trans=True),
            v1.img_pool3d_layer(c3, pool_size=2, stride=2)]
    return outs, {"pvimg": _rand(41, 2, 2, 5, 6),
                  "pvvol": _rand(42, 2, 2, 4, 4, 4)}


def lay_selection_and_distances(p):
    """scale_sub_region, multiplex, row_l2_norm (norm), l2_distance
    (squared_l2_distance), repeat (expand), conv_shift and tensor_layer
    (bilinear_tensor_product)."""
    v1 = p.v1
    img = v1.data_layer("sdimg", size=2 * 3 * 3, height=3, width=3)
    idx = v1.data_layer("sdidx", size=6)
    ids = v1.data_layer("sdid", size=1, dtype="int64")
    a = v1.data_layer("sda", size=5)
    b = v1.data_layer("sdb", size=5)
    c = v1.data_layer("sdc", size=3)
    outs = [v1.scale_sub_region_layer(img, idx, value=3.0),
            v1.multiplex_layer([ids, a, b]), v1.row_l2_norm_layer(a),
            v1.l2_distance_layer(a, b),
            v1.repeat_layer(a, 2, as_row_vector=True),
            v1.repeat_layer(a, 3, as_row_vector=False),
            v1.conv_shift_layer(a, c), v1.tensor_layer(a, b, size=3)]
    return outs, {"sdimg": _rand(43, 2, 2, 3, 3),
                  "sdidx": np.array([[1, 2, 1, 2, 2, 3], [2, 2, 3, 3, 1, 1]],
                                    np.float32),
                  "sdid": np.array([[1], [0]], np.int64),
                  "sda": _rand(44, 2, 5), "sdb": _rand(45, 2, 5),
                  "sdc": _rand(46, 2, 3)}


def lay_costs(p):
    """The v1 costs of the new op types: huber regression and
    classification, rank, self-normalized cross entropy, smooth L1 and
    LambdaRank."""
    v1, act = p.v1, p.act
    score = v1.data_layer("vc_sc", size=1)
    lab01 = v1.data_layer("vc_lab", size=1)
    left = v1.data_layer("vc_l", size=1)
    right = v1.data_layer("vc_r", size=1)
    probs = v1.fc_layer(v1.data_layer("vc_x", size=6), size=4,
                        act=act.SoftmaxActivation())
    ilab = v1.data_layer("vc_il", size=1, dtype="int64")
    s = v1.data_layer("vc_s", size=1, seq=True)
    rel = v1.data_layer("vc_rel", size=1, seq=True)
    outs = [v1.huber_regression_cost(score, lab01, delta=0.5),
            v1.huber_classification_cost(score, lab01),
            v1.rank_cost(left, right, lab01),
            v1.cross_entropy_with_selfnorm(probs, ilab),
            v1.smooth_l1_cost(score, lab01),
            v1.lambda_cost(s, rel, NDCG_num=3)]
    feeds = {"vc_sc": np.array([[-1.5], [0.2], [0.9], [2.0]], np.float32),
             "vc_lab": np.array([[1], [0], [1], [0]], np.float32),
             "vc_l": _rand(47, 4, 1), "vc_r": _rand(48, 4, 1),
             "vc_x": _rand(49, 4, 6),
             "vc_il": np.array([[0], [3], [1], [2]], np.int64)}
    rng = np.random.RandomState(50)
    feeds.update(_seqs(p, "vc_s", [_rand(51, 5, 1), _rand(52, 3, 1),
                                   _rand(53, 4, 1), _rand(54, 2, 1)]))
    feeds.update(_seqs(p, "vc_rel", [
        rng.randint(0, 3, (n, 1)).astype(np.float32) for n in (5, 3, 4, 2)]))
    return outs, feeds


def lay_cross_entropy_over_beam(p):
    """The beam cost over kmax candidates, with a row shorter than the
    beam (padded candidates leave the softmax) and a gold outside it."""
    v1 = p.v1
    scores = v1.data_layer("cb_sc", size=1, seq=True)
    topk = v1.kmax_seq_score_layer(scores, beam_size=3)
    gold = v1.data_layer("cb_gold", size=1, dtype="int64")
    cost = v1.cross_entropy_over_beam(
        v1.BeamInput(candidate_scores=scores, selected_candidates=topk,
                     gold=gold))
    feeds = _seqs(p, "cb_sc", [np.array([[0.5], [0.1], [3.0], [0.2]],
                                        np.float32),
                               np.array([[2.0], [1.0]], np.float32),
                               np.array([[0.3], [0.9], [0.4], [0.8]],
                                        np.float32)])
    feeds["cb_gold"] = np.array([[2], [0], [2]], np.int64)
    return [cost, topk], feeds


def lay_hsigmoid_fm_selective_fc_adam_steps(p):
    """hsigmoid, factorization_machine and selective_fc trained jointly:
    three Adam steps, the fetched loss of each and the step-1 outputs."""
    v1 = p.v1
    p.v1_pkg.settings(learning_rate=5e-2,
                      learning_method=p.v1_pkg.AdamOptimizer())
    x = v1.data_layer("hfx", size=8)
    label = v1.data_layer("hfl", size=1, dtype="int64")
    sel = v1.data_layer("hfsel", size=5)
    hcost = v1.hsigmoid(x, label, num_classes=6)
    fm = v1.factorization_machine(x, factor_size=3)
    sfc = v1.selective_fc_layer(x, size=5, select=sel)
    fit = v1.mse_cost(v1.fc_layer(v1.concat_layer([fm, sfc]), size=1),
                      v1.data_layer("hft", size=1))
    joint = p.fluid.layers.elementwise_add(hcost.var, fit.var)
    p.v1_pkg.optimizer_from_settings().minimize(joint)
    rng = np.random.RandomState(5)
    xs = rng.randn(6, 8).astype(np.float32)
    mask = (rng.rand(6, 5) > 0.4).astype(np.float32)
    return [joint, fm, sfc], {
        "hfx": xs, "hfl": rng.randint(0, 6, (6, 1)).astype(np.int64),
        "hfsel": mask, "hft": (xs[:, :1] * xs[:, 1:2]).astype(np.float32)}


LAYERS = [v for k, v in sorted(globals().items()) if k.startswith("lay_")]


def _var(out):
    return getattr(out, "var", out)


def _persistables(program):
    return [n for n, v in program.global_block().vars.items()
            if v.persistable]


def _run_both(builder, steps):
    """`builder(p)` in both packages; the port loads the JAX startup's
    values by name and both run the same feeds `steps` times.  Returns
    (port fetches, JAX fetches), one list a step."""
    jfluid.reset()
    j_outs, j_feed = builder(PKG["jax"])
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    state = {n: np.array(jfluid.global_scope().find_np(n))
             for n in _persistables(jfluid.default_main_program())}
    j_got = [jexe.run(feed=j_feed, fetch_list=[_var(o) for o in j_outs])
             for _ in range(steps)]
    tfluid.reset()
    t_outs, t_feed = builder(PKG["port"])
    assert tfluid.default_main_program().to_json() == \
        jfluid.default_main_program().to_json()
    tfluid.load_persistables(tfluid.default_main_program(), state)
    texe = tfluid.Executor(tfluid.CPUPlace())
    t_got = [texe.run(feed=t_feed, fetch_list=[_var(o) for o in t_outs])
             for _ in range(steps)]
    return t_got, j_got


def _hold(t_got, j_got, tag):
    for k, (t, j) in enumerate(zip(t_got, j_got)):
        t, j = np.asarray(t), np.asarray(j)
        assert t.shape == j.shape, (tag, k, t.shape, j.shape)
        if np.issubdtype(j.dtype, np.integer) or j.dtype == bool:
            np.testing.assert_array_equal(t, j, err_msg=f"{tag}[{k}]")
            continue
        scale = max(float(np.abs(j).max()), 1e-30) if j.size else 1.0
        err = float(np.abs(t.astype(np.float64) - j).max()) if j.size else 0.
        assert err <= TOL * scale, (tag, k, err, scale)


@pytest.mark.parametrize("builder", LAYERS,
                         ids=[f.__name__[4:] for f in LAYERS])
def test_v1_layers_run_as_in_jax(builder):
    steps = 3 if "steps" in builder.__name__ else 1
    t_got, j_got = _run_both(builder, steps)
    for k, (t, j) in enumerate(zip(t_got, j_got)):
        _hold(t, j, f"{builder.__name__} step {k}")
