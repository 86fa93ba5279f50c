"""The diffusion U-Net (DDPM), the port of ``paddle_tpu/models/unet.py``:
a timestep-conditioned U-Net (residual conv blocks, sinusoidal time
embeddings through ``layers.sin``/``cos``, skip connections,
transposed-conv upsampling) trained with the DDPM noise-prediction
objective, and two host-loop samplers.

The timesteps arrive as a fed tensor and the schedule's coefficients
sqrt(ᾱ_t) and sqrt(1 − ᾱ_t) are fed a batch at a time (the host looks
them up in ``ddpm_schedule``), so the program has static shapes and no
gather over a schedule table.  The samplers run one denoise step a
call of the test-mode clone; numpy in, numpy out.

API:
    loss, eps_hat, infer_prog = build_ddpm_train_program(
        image_size=32, channels=3)   # infer_prog cloned before minimize
    # feed (ddpm_feed builds it): image/noise [B,C,H,W],
    #   t / sqrt_ab / sqrt_1mab [B,1] f32
    sched = ddpm_schedule(T=1000)          # host-side linear betas
    ddpm_sample(exe, infer_prog, eps_hat, sched, shape, rng)
"""

from __future__ import annotations

import numpy as np

from .. import layers
from ..framework.layer_helper import LayerHelper


def _time_embedding(t, dim):
    """Sinusoidal timestep embedding -> [B, dim] (t: [B,1] float32): the
    host's [1, dim/2] frequencies as an ``assign_value`` constant, t @
    freqs through ``layers.mul``, then sin and cos concatenated."""
    half = dim // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / max(half - 1, 1))
    helper = LayerHelper("time_embed")
    fvar = helper.create_tmp_variable("float32", shape=(1, half))
    helper.append_op(
        "assign_value", outputs={"Out": [fvar.name]},
        attrs={"shape": [1, half], "dtype": "float32",
               "fp32_values": [float(v) for v in freqs]})
    ang = layers.mul(t, fvar)            # [B, half]
    return layers.concat([layers.sin(ang), layers.cos(ang)], axis=1)


def _res_block(x, t_emb, ch, name):
    """Conv-BN-swish x2 with the time embedding added between convs and
    a 1x1-projected residual skip."""
    h = layers.conv2d(x, num_filters=ch, filter_size=3, padding=1,
                      name=f"{name}_c1")
    h = layers.batch_norm(h, act="swish", name=f"{name}_bn1")
    # [B, ch] time signal broadcast over H,W (axis=0: align at batch)
    temb = layers.fc(t_emb, size=ch, act="swish", name=f"{name}_temb")
    h = layers.elementwise_add(h, temb, axis=0)
    h = layers.conv2d(h, num_filters=ch, filter_size=3, padding=1,
                      name=f"{name}_c2")
    h = layers.batch_norm(h, act=None, name=f"{name}_bn2")
    skip = x
    if x.shape[1] != ch:
        skip = layers.conv2d(x, num_filters=ch, filter_size=1,
                             name=f"{name}_skip")
    return layers.swish(layers.elementwise_add(h, skip))


def unet2d(x, t, base_ch=32, ch_mults=(1, 2), out_channels=None,
           temb_dim=None):
    """Timestep-conditioned U-Net: x [B,C,H,W], t [B,1] float32 ->
    noise prediction [B,out_channels,H,W]."""
    out_channels = out_channels or int(x.shape[1])
    temb_dim = temb_dim or base_ch * 4
    t_emb = _time_embedding(t, temb_dim)
    t_emb = layers.fc(t_emb, size=temb_dim, act="swish", name="temb_fc")

    # encoder
    h = layers.conv2d(x, num_filters=base_ch, filter_size=3, padding=1,
                      name="in_conv")
    skips = []
    for i, m in enumerate(ch_mults):
        h = _res_block(h, t_emb, base_ch * m, f"down{i}")
        skips.append(h)
        if i < len(ch_mults) - 1:
            h = layers.conv2d(h, num_filters=base_ch * m, filter_size=3,
                              stride=2, padding=1, name=f"down{i}_pool")

    # bottleneck
    h = _res_block(h, t_emb, base_ch * ch_mults[-1], "mid")

    # decoder
    for i in reversed(range(len(ch_mults))):
        m = ch_mults[i]
        if i < len(ch_mults) - 1:
            h = layers.conv2d_transpose(h, num_filters=base_ch * m,
                                        filter_size=2, stride=2,
                                        name=f"up{i}_convt")
        h = layers.concat([h, skips[i]], axis=1)
        h = _res_block(h, t_emb, base_ch * m, f"up{i}")

    return layers.conv2d(h, num_filters=out_channels, filter_size=3,
                         padding=1, name="out_conv")


def build_ddpm_train_program(image_size=32, channels=3, base_ch=32,
                             ch_mults=(1, 2), learning_rate=1e-3,
                             optimizer="adam"):
    """Noise-prediction training step: x_t = sqrt_ab*x0 + sqrt_1mab*eps
    built IN-GRAPH from fed coefficients; loss = mean((eps_hat-eps)^2).
    Returns (loss, eps_hat, infer_prog) — infer_prog is the pre-minimize
    test-mode clone the samplers run."""
    from .. import optimizer as opt

    x0 = layers.data("image", shape=[channels, image_size, image_size],
                     dtype="float32")
    eps = layers.data("noise", shape=[channels, image_size, image_size],
                      dtype="float32")
    t = layers.data("t", shape=[1], dtype="float32")
    sqrt_ab = layers.data("sqrt_ab", shape=[1], dtype="float32")
    sqrt_1mab = layers.data("sqrt_1mab", shape=[1], dtype="float32")

    x_t = layers.elementwise_add(
        layers.elementwise_mul(x0, sqrt_ab, axis=0),
        layers.elementwise_mul(eps, sqrt_1mab, axis=0))
    eps_hat = unet2d(x_t, t, base_ch=base_ch, ch_mults=ch_mults,
                     out_channels=channels)
    loss = layers.mean(layers.square(
        layers.elementwise_sub(eps_hat, eps)))
    # the test-mode clone before the optimizer ops exist: sampling through
    # a clone made after minimize would update the parameters on every
    # denoise step
    from ..framework.core import default_main_program

    infer_prog = default_main_program().clone(for_test=True)
    if optimizer == "adam":
        opt.Adam(learning_rate=learning_rate).minimize(loss)
    elif optimizer == "sgd":
        opt.SGD(learning_rate=learning_rate).minimize(loss)
    elif optimizer is not None:
        raise ValueError(f"optimizer {optimizer!r}: use 'adam'/'sgd'/None")
    return loss, eps_hat, infer_prog


def ddpm_schedule(T=1000, beta_start=1e-4, beta_end=0.02):
    """Host-side linear-beta schedule: dict of per-step coefficient
    arrays (the feed source for sqrt_ab / sqrt_1mab)."""
    betas = np.linspace(beta_start, beta_end, T, dtype=np.float64)
    alphas = 1.0 - betas
    ab = np.cumprod(alphas)
    return {
        "T": T,
        "betas": betas.astype(np.float32),
        "alphas": alphas.astype(np.float32),
        "alphas_bar": ab.astype(np.float32),
        "sqrt_ab": np.sqrt(ab).astype(np.float32),
        "sqrt_1mab": np.sqrt(1.0 - ab).astype(np.float32),
    }


def ddpm_feed(x0, sched, rng):
    """One training feed: sample t/eps host-side, look up coefficients."""
    B = x0.shape[0]
    t = rng.randint(0, sched["T"], size=(B,))
    eps = rng.randn(*x0.shape).astype(np.float32)
    return {
        "image": x0.astype(np.float32),
        "noise": eps,
        "t": t.reshape(B, 1).astype(np.float32),
        "sqrt_ab": sched["sqrt_ab"][t].reshape(B, 1),
        "sqrt_1mab": sched["sqrt_1mab"][t].reshape(B, 1),
    }


def ddim_sample(exe, infer_prog, eps_hat_var, sched, shape, rng,
                steps=50):
    """DDIM (eta=0, deterministic) sampling: the few-step sampler —
    x_{t-1} = sqrt(ab_prev) * x0_hat + sqrt(1-ab_prev) * eps_hat with
    x0_hat = (x_t - sqrt(1-ab_t) eps_hat) / sqrt(ab_t).  The same denoise
    step as ddpm_sample (the test-mode clone with the identity feed)."""
    T = sched["T"]
    use_t = np.linspace(T - 1, 0, steps).round().astype(int)
    x = rng.randn(*shape).astype(np.float32)
    B = shape[0]
    zero = np.zeros(shape, np.float32)
    one = np.ones((B, 1), np.float32)
    for k, ti in enumerate(use_t):
        feed = {
            "image": x, "noise": zero, "sqrt_ab": one,
            "sqrt_1mab": np.zeros((B, 1), np.float32),
            "t": np.full((B, 1), float(ti), np.float32),
        }
        (eh,) = exe.run(infer_prog, feed=feed, fetch_list=[eps_hat_var])
        eh = np.asarray(eh)
        ab_t = sched["alphas_bar"][ti]
        x0_hat = (x - np.sqrt(1.0 - ab_t) * eh) / np.sqrt(ab_t)
        if k == len(use_t) - 1:
            x = x0_hat
        else:
            ab_prev = sched["alphas_bar"][use_t[k + 1]]
            x = (np.sqrt(ab_prev) * x0_hat
                 + np.sqrt(1.0 - ab_prev) * eh).astype(np.float32)
    return x


def ddpm_sample(exe, infer_prog, eps_hat_var, sched, shape, rng,
                steps=None):
    """Ancestral DDPM sampling as a host loop over one denoise step.
    `infer_prog` is the training program's test-mode clone: feeding
    sqrt_ab=1 / sqrt_1mab=0 / noise=0 makes the in-program x_t equal the
    fed image, so the same parameter and BatchNorm statistic names serve
    sampling (a rebuilt program would mint fresh statistic names)."""
    T = sched["T"]
    steps = steps or T
    use_t = np.linspace(T - 1, 0, steps).round().astype(int)
    x = rng.randn(*shape).astype(np.float32)
    B = shape[0]
    zero = np.zeros(shape, np.float32)
    one = np.ones((B, 1), np.float32)
    for ti in use_t:
        feed = {
            "image": x,  # x_t = 1*image + 0*noise (identity feed trick)
            "noise": zero,
            "sqrt_ab": one,
            "sqrt_1mab": np.zeros((B, 1), np.float32),
            "t": np.full((B, 1), float(ti), np.float32),
        }
        (eh,) = exe.run(infer_prog, feed=feed, fetch_list=[eps_hat_var])
        eh = np.asarray(eh)
        a_t = sched["alphas"][ti]
        ab_t = sched["alphas_bar"][ti]
        coef = (1.0 - a_t) / np.sqrt(1.0 - ab_t)
        x = (x - coef * eh) / np.sqrt(a_t)
        if ti > 0:
            x = x + np.sqrt(sched["betas"][ti]) * \
                rng.randn(*shape).astype(np.float32)
    return x
