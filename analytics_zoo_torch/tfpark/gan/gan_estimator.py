"""GANEstimator: alternating generator/discriminator training (port of
the JAX package's ``tfpark/gan/gan_estimator.py``).

The two adversarial updates are two train steps under ``engine_jit``
(captured into CUDA graphs on the card); the alternation schedule is
host-side and exact: ``d_steps`` discriminator updates, then ``g_steps``
generator updates, each step owning its param tree.  The optimizers'
own (unfused) updates run, as in the reference.  Randomness comes from
an explicit ``torch.Generator`` seeded by the caller: it draws the
minibatch indices, the noise and each step's seed; inside a step every
stochastic apply (the generator, the discriminator on real samples, the
discriminator on fakes) folds its own name into the step's generator,
as the reference splits its key.  The loss functions mirror
tf.contrib.gan's standard set.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_torch.pipeline.api.keras.engine import fold_name
from analytics_zoo_torch.pipeline.api.keras.topology import (
    tree_leaves, tree_map, tree_replace)

log = logging.getLogger("analytics_zoo_torch.gan")


# --------------------------------------------------------------- GAN losses
def modified_generator_loss(fake_logits):
    """Non-saturating GAN loss: -log sigmoid(D(G(z)))."""
    return -torch.mean(F.logsigmoid(fake_logits))


def modified_discriminator_loss(real_logits, fake_logits):
    # log(1 - sigmoid(x)) == log_sigmoid(-x), numerically stable
    return -(torch.mean(F.logsigmoid(real_logits))
             + torch.mean(F.logsigmoid(-fake_logits)))


def wasserstein_generator_loss(fake_logits):
    return -torch.mean(fake_logits)


def wasserstein_discriminator_loss(real_logits, fake_logits):
    return torch.mean(fake_logits) - torch.mean(real_logits)


def least_squares_generator_loss(fake_logits):
    return 0.5 * torch.mean((fake_logits - 1.0) ** 2)


def least_squares_discriminator_loss(real_logits, fake_logits):
    return 0.5 * (torch.mean((real_logits - 1.0) ** 2)
                  + torch.mean(fake_logits ** 2))


def _grads_of(loss_of, params):
    """(loss, grads like ``params``, aux) of ``loss_of(params) -> (loss,
    aux)`` by autograd."""
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_of(tree_replace(params, live))
    grads = torch.autograd.grad(loss, live, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), tree_replace(params, list(grads)), aux


def _detached(tree):
    return tree_map(lambda t: t.detach() if torch.is_tensor(t) else t, tree)


class GANEstimator:
    def __init__(self, generator, discriminator,
                 generator_loss_fn: Callable = modified_generator_loss,
                 discriminator_loss_fn: Callable =
                 modified_discriminator_loss,
                 generator_optim_method=None,
                 discriminator_optim_method=None,
                 d_steps: int = 1, g_steps: int = 1,
                 model_dir: Optional[str] = None):
        """``generator``/``discriminator``: native models (noise→sample,
        sample→logits)."""
        from analytics_zoo_torch.pipeline.api.keras import optimizers
        self.generator = generator
        self.discriminator = discriminator
        self.g_loss_fn = generator_loss_fn
        self.d_loss_fn = discriminator_loss_fn
        self.g_optim = optimizers.get(generator_optim_method) \
            or optimizers.Adam(lr=1e-4)
        self.d_optim = optimizers.get(discriminator_optim_method) \
            or optimizers.Adam(lr=1e-4)
        self.d_steps = d_steps
        self.g_steps = g_steps
        self.model_dir = model_dir
        self._built = False

    def _build(self, rng: torch.Generator):
        gv = self.generator.init(rng=fold_name(rng, "generator"))
        dv = self.discriminator.init(rng=fold_name(rng, "discriminator"))
        self.g_params, self.g_state = gv["params"], gv["state"]
        self.d_params, self.d_state = dv["params"], dv["state"]
        self.g_opt_state = self.g_optim.init(self.g_params)
        self.d_opt_state = self.d_optim.init(self.d_params)

        gen, disc = self.generator, self.discriminator
        g_loss_fn, d_loss_fn = self.g_loss_fn, self.d_loss_fn
        g_optim, d_optim = self.g_optim, self.d_optim

        def d_step(g_params, d_params, g_state, d_state, d_opt_state,
                   real, noise, rng):
            # one generator per stochastic apply: reusing `rng` would
            # hand G and both D passes identical dropout masks
            with torch.no_grad():
                fake, _ = gen.apply(g_params, noise, state=g_state,
                                    training=True,
                                    rng=fold_name(rng, "g"))

            def loss(dp):
                real_logits, ds = disc.apply(dp, real, state=d_state,
                                             training=True,
                                             rng=fold_name(rng, "dr"))
                fake_logits, _ = disc.apply(dp, fake, state=ds,
                                            training=True,
                                            rng=fold_name(rng, "df"))
                return d_loss_fn(real_logits, fake_logits), ds
            l, grads, new_state = _grads_of(loss, d_params)
            with torch.no_grad():
                updates, new_opt = d_optim.update(grads, d_opt_state,
                                                  d_params)
                new_params = tree_map(lambda p, u: p + u, d_params, updates)
            return new_params, _detached(new_state), new_opt, l

        def g_step(g_params, d_params, g_state, d_state, g_opt_state,
                   noise, rng):
            def loss(gp):
                fake, gs = gen.apply(gp, noise, state=g_state,
                                     training=True,
                                     rng=fold_name(rng, "g"))
                fake_logits, _ = disc.apply(d_params, fake, state=d_state,
                                            training=True,
                                            rng=fold_name(rng, "d"))
                return g_loss_fn(fake_logits), gs
            l, grads, new_state = _grads_of(loss, g_params)
            with torch.no_grad():
                updates, new_opt = g_optim.update(grads, g_opt_state,
                                                  g_params)
                new_params = tree_map(lambda p, u: p + u, g_params, updates)
            return new_params, _detached(new_state), new_opt, l

        from analytics_zoo_torch.compile import engine_jit
        self._d_step = engine_jit(d_step, key_hint="gan_d_step")
        self._g_step = engine_jit(g_step, key_hint="gan_g_step")
        self._built = True

    def _device(self):
        return tree_leaves(self.g_params)[0].device

    def train(self, real_data, noise_dim: int, batch_size: int = 32,
              steps: int = 100, rng=None, log_every: int = 50):
        """Alternate ``d_steps`` discriminator and ``g_steps`` generator
        updates per iteration (GanOptimMethod semantics).  ``rng``: a
        CPU ``torch.Generator`` or an int seed (default 0)."""
        from analytics_zoo_torch.parallel.trainer import step_generator
        if not isinstance(rng, torch.Generator):
            rng = torch.Generator().manual_seed(0 if rng is None
                                                else int(rng))

        def draw_seed() -> int:
            return int(torch.randint(0, 2 ** 62, (1,), generator=rng))
        if not self._built:
            self._build(torch.Generator().manual_seed(draw_seed()))
        real_data = np.asarray(real_data)
        n = len(real_data)
        dev = self._device()
        history = []
        for step in range(steps):
            d_loss = g_loss = None
            for _ in range(self.d_steps):
                # the minibatch gather is host-side: real_data lives there
                idx = torch.randint(0, n, (batch_size,), generator=rng)
                real = torch.from_numpy(real_data[idx.numpy()]).to(dev)
                noise = torch.randn((batch_size, noise_dim),
                                    generator=rng).to(dev)
                self.d_params, self.d_state, self.d_opt_state, d_loss = \
                    self._d_step(self.g_params, self.d_params,
                                 self.g_state, self.d_state,
                                 self.d_opt_state, real, noise,
                                 step_generator(draw_seed(), step, dev))
            for _ in range(self.g_steps):
                noise = torch.randn((batch_size, noise_dim),
                                    generator=rng).to(dev)
                self.g_params, self.g_state, self.g_opt_state, g_loss = \
                    self._g_step(self.g_params, self.d_params,
                                 self.g_state, self.d_state,
                                 self.g_opt_state, noise,
                                 step_generator(draw_seed(), step, dev))
            entry = {}
            if d_loss is not None:
                entry["d_loss"] = float(d_loss)
            if g_loss is not None:
                entry["g_loss"] = float(g_loss)
            if (step + 1) % log_every == 0:
                log.info("step %d %s", step + 1,
                         " ".join(f"{k} {v:.4f}" for k, v in
                                  entry.items()))
            history.append(entry)
        return history

    def generate(self, noise) -> np.ndarray:
        """Sample from the trained generator."""
        x = torch.as_tensor(np.asarray(noise, np.float32)).to(self._device())
        with torch.no_grad():
            out, _ = self.generator.apply(self.g_params, x,
                                          state=self.g_state,
                                          training=False)
        return out.cpu().numpy()
