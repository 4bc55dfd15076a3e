"""The cohort round's corrupt flags under --quarantine (fl/rounds.
make_cohort_round_fn) against the JAX package's `make_cohort_round_fn`.

JAX ANDs the quarantine into `active` before it makes the corrupt flags
`(ids < num_corrupt) & active` (fl/rounds.py:794-799), so a quarantined
attacker is not among the attackers `--faults_spare_corrupt` spares. The
setup is JAX tests/test_population.py:664's (dropout 1.0 with the
attackers spared: exact arithmetic) plus `--quarantine 0`, on a cohort
that holds client 0 and another corrupt client, all members active: the
dropped count is m minus the corrupt members that are not quarantined, on
both sides, and the electorate is those members. Controlled as
tests/test_torch_cohort_round.py: JAX's cohort fed to the port's round,
a Flax init carried across, dropout off, JAX's epoch permutations
injected; JAX's round under its own plain `jax.jit`.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig)
from defending_against_backdoors_with_robust_learning_rate_tpu.data import (
    cohort as jax_cohort)
from defending_against_backdoors_with_robust_learning_rate_tpu.data.registry import (
    get_cohort_data as jax_get_cohort_data)
from defending_against_backdoors_with_robust_learning_rate_tpu.fl import (
    rounds as jax_rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu.fl.common import (
    make_normalizer as jax_make_normalizer)
from defending_against_backdoors_with_robust_learning_rate_tpu.models.cnn import (
    CNN_MNIST as JaxCNN)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.data.registry import (
    get_cohort_data)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    common, rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    carrier, registry)

SHAPE = (8, 8, 1)
MEAN, STD = (0.5,), (0.5,)
CORRUPT = 6
KW = dict(data="synthetic", num_agents=64, cohort_sampled="on",
          cohort_size=8, partitioner="dirichlet", bs=32, local_ep=1,
          synth_train_size=1024, synth_val_size=64, num_corrupt=CORRUPT,
          poison_frac=0.5, robustLR_threshold=2, dropout_rate=1.0,
          faults_spare_corrupt=True, quarantine="0")


class _NoDropout:
    def __init__(self, inner):
        self._inner = inner

    def apply(self, variables, x, train=False, rngs=None):
        del train, rngs
        return self._inner.apply(variables, x, train=False)


def _epoch_perms(key, size, n_total):
    shuffle_key, _ = jax.random.split(jax.random.split(key, 1)[0])
    r = jax.random.uniform(shuffle_key, (n_total,))
    r = jnp.where(jnp.arange(n_total) < size, r, 2.0)
    return [torch.from_numpy(np.array(jnp.argsort(r))).long()]


def test_quarantined_attacker_is_not_spared(tmp_path):
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        data_dir = str(tmp_path / "nodata")
        jcfg = JaxConfig(**KW, data_dir=data_dir, log_dir=str(tmp_path / "j"))
        cfg = Config(**KW, data_dir=data_dir, log_dir=str(tmp_path / "p"),
                     device="cpu")

        def holds_0_and_another(r):
            ids, active = jax_cohort.sample_cohort_host(jcfg, r)
            return (active.all() and 0 in ids
                    and int((ids < CORRUPT).sum()) >= 2)
        rnd = next(r for r in range(1, 2000) if holds_0_and_another(r))
        ids, active = jax_cohort.sample_cohort_host(jcfg, rnd)
        m = len(ids)
        spared = int(((ids < CORRUPT) & (ids != 0)).sum())
        assert spared >= 1

        imgs, lbls, szs = jax_get_cohort_data(jcfg).gather_cohort(ids)
        src = get_cohort_data(cfg)
        for got, want in zip(src.gather_cohort(ids), (imgs, lbls, szs),
                             strict=True):
            np.testing.assert_array_equal(got, want)
        rng = np.random.default_rng(0)
        shapes = jax.eval_shape(JaxCNN().init, jax.random.PRNGKey(0),
                                jnp.zeros((1,) + SHAPE))["params"]
        flax_params = {mod: {name: (rng.normal(size=leaf.shape) / np.sqrt(
            np.prod(leaf.shape[:-1]) if name == "kernel" else 10.0)).astype(
                np.float32) for name, leaf in leaves.items()}
            for mod, leaves in shapes.items()}
        key = jax.random.PRNGKey(3)
        _, j_info = jax_rounds.make_cohort_round_fn(
            jcfg, _NoDropout(JaxCNN()), jax_make_normalizer(MEAN, STD, False))(
                flax_params, key, jnp.int32(rnd), jnp.asarray(imgs),
                jnp.asarray(lbls), jnp.asarray(szs))
        agent_keys = jax.random.split(jax.random.split(key)[0], m)
        perms = [_epoch_perms(agent_keys[s], int(szs[s]), src.max_n)
                 for s in range(m)]

        model = registry.get_model("synthetic", SHAPE)
        norm = common.make_normalizer(MEAN, STD, "cpu")
        rr = rounds.RoundRNG(0, "cpu")
        rr.round = rnd - 1
        _, info = rounds.make_cohort_round_fn(cfg, model, norm, src.max_n,
                                              "cpu")(
            carrier.params_from_flax(flax_params, "cpu"), rr, ids,
            torch.from_numpy(imgs), torch.from_numpy(lbls).long(),
            torch.from_numpy(szs), active, szs, perms=perms, dropout=False)
    finally:
        torch.set_num_threads(old)
    # JAX: the quarantined attacker 0 is dropped, the other attackers are
    # spared and vote
    assert float(j_info["fault_dropped"]) == m - spared
    assert float(j_info["fault_voters"]) == spared
    for k in ("fault_dropped", "fault_voters", "fault_straggled"):
        assert float(info[k]) == float(j_info[k]), k
