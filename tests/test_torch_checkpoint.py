"""The port's checkpoint module (utils/checkpoint.py) against the JAX
package's, on one scripted sequence, and its refusals.

(a) The same sequence through both modules, each in its own directory
under tmp_path: save rounds 2, 4 and 6, leave a save's temporary
directory behind, corrupt the newest checkpoint's bytes, journal the
three rounds, prune to the 2 newest. Held exactly: `saved_rounds`,
`latest_round`, `digest_valid` of every round, `newest_valid_round`,
`newest_resumable_round`, the round `restore` falls back to, its params
(bit for bit) and `cum_poison_acc` / `cum_net_mov`, `journal_read`
(minus `wall_time`) and `journal_offset_for`. JAX's `save` runs orbax on
the CPU; its PRNG key and the port's `RoundRNG` state are each held to
what was saved.

(b) What does not fit raises: other param names, other shapes, and a
generator state written on another device type (saved from a run on a
card, restored into params on the CPU); an empty directory restores
None, and `RoundRNG.load_state` continues the streams.

No process is spawned; everything is written under tmp_path.
At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu.utils import (
    checkpoint as jax_ckpt)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl.rounds import (
    RoundRNG)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils import (
    checkpoint as ckpt)

ROUNDS = (2, 4, 6)
CUM = {2: (0.5, -0.25), 4: (1.25, 0.5), 6: (2.0, 1.75)}


def _params(rnd):
    rng = np.random.default_rng(rnd)
    return {"Conv_0.weight": rng.normal(size=(4, 1, 3, 3)).astype(np.float32),
            "Conv_0.bias": rng.normal(size=(4,)).astype(np.float32)}


def _corrupt(path):
    """Flip one byte of the first file under a checkpoint directory."""
    first = min(os.path.join(b, f) for b, _, fs in os.walk(path) for f in fs)
    with open(first, "r+b") as f:
        byte = f.read(1)
        f.seek(0)
        f.write(bytes([byte[0] ^ 0xFF]))


def _sequence(mod, d, save):
    for rnd in ROUNDS:
        save(d, rnd)
    # a save cut before its move into place: both packages' names
    os.makedirs(os.path.join(d, "round_000008.tmp-4242"))
    os.makedirs(os.path.join(d, "round_000008.orbax-checkpoint-tmp-4242"))
    _corrupt(os.path.join(d, "round_000006"))
    for rnd in ROUNDS:
        mod.journal_record(d, rnd, 100 * rnd,
                           health={"n": rnd, "loss_ema": 0.1 * rnd},
                           reputation={"rounds": rnd, "clients": {}})
    mod.prune(d, keep_last=2)
    return {
        "saved": mod.saved_rounds(d),
        "latest": mod.latest_round(d),
        "digests": [mod.digest_valid(d, r) for r in ROUNDS],
        "valid": mod.newest_valid_round(d),
        "resumable": mod.newest_resumable_round(d),
        "journal": [{k: v for k, v in e.items() if k != "wall_time"}
                    for e in mod.journal_read(d)],
        "offsets": [mod.journal_offset_for(d, r) for r in ROUNDS],
        "journal_file": os.path.basename(mod.journal_path(d)),
    }


def test_checkpoint_sequence_matches_jax(tmp_path, capsys):
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    key = jax.random.PRNGKey(123)
    rng = RoundRNG(7, "cpu")
    rng.round = 6
    torch.randint(0, 10, (5,), generator=rng.host)
    states = {}

    def jax_save(d, rnd):
        jax_ckpt.save(d, rnd, {k: jnp.asarray(v)
                               for k, v in _params(rnd).items()}, key,
                      CUM[rnd][0], cum_net_mov=CUM[rnd][1])

    def port_save(d, rnd):
        states[rnd] = rng.state_dict()
        ckpt.save(d, rnd, {k: torch.from_numpy(v)
                           for k, v in _params(rnd).items()},
                  states[rnd], CUM[rnd][0], cum_net_mov=CUM[rnd][1])
        torch.rand(3, generator=rng.noise)

    want = _sequence(jax_ckpt, jd, jax_save)
    got = _sequence(ckpt, td, port_save)
    assert got == want
    assert got["saved"] == [4, 6] and got["digests"] == [None, True, False]
    assert got["valid"] == got["resumable"] == 4

    capsys.readouterr()
    j_rnd, j_params, j_key, j_cpa, j_cnm = jax_ckpt.restore(
        jd, {k: jnp.zeros(v.shape) for k, v in _params(0).items()})
    j_line = capsys.readouterr().out
    like = {k: torch.zeros(v.shape) for k, v in _params(0).items()}
    t_rnd, t_params, t_rng, t_cpa, t_cnm = ckpt.restore(td, like)
    assert capsys.readouterr().out == j_line
    assert "round_000006: digest mismatch" in j_line
    assert (t_rnd, t_cpa, t_cnm) == (j_rnd, j_cpa, j_cnm) == (4, *CUM[4])
    for k, v in _params(4).items():
        np.testing.assert_array_equal(np.asarray(j_params[k]), v)
        assert t_params[k].device.type == "cpu"
        np.testing.assert_array_equal(t_params[k].numpy(), v)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(j_key)),
                                  np.asarray(jax.random.key_data(key)))
    assert t_rng["round"] == states[4]["round"] == 6
    for name in ("host", "noise"):
        assert torch.equal(t_rng[name], states[4][name]), name
    # upto pins the newest round considered; upto=0 restores nothing
    assert ckpt.restore(td, like, upto=0) is None
    assert ckpt.restore(td, like, upto=4, upto_validated=True)[0] == 4


def test_checkpoint_mismatch_raises_and_rng_continues(tmp_path):
    d = str(tmp_path / "ck")
    assert ckpt.restore(str(tmp_path / "empty"), {}) is None
    assert ckpt.latest_round(str(tmp_path / "empty")) is None
    params = {k: torch.from_numpy(v) for k, v in _params(1).items()}
    rng = RoundRNG(3, "cpu")
    ckpt.save(d, 1, params, rng.state_dict(), 0.0)
    with pytest.raises(ValueError, match="params"):
        ckpt.restore(d, {"renamed": torch.zeros(4)})
    with pytest.raises(ValueError, match="params"):
        ckpt.restore(d, {"Conv_0.weight": torch.zeros(4, 1, 5, 5),
                         "Conv_0.bias": torch.zeros(4)})
    with pytest.raises(ValueError, match="float64"):
        ckpt.restore(d, {k: v.double() for k, v in params.items()})

    # a card run's checkpoint (its noise generator is a CUDA one) restored
    # into params on the CPU: the streams cannot carry over
    card = dict(rng.state_dict(), device="cuda")
    ckpt.save(str(tmp_path / "card"), 2, params, card, 0.0)
    with pytest.raises(ValueError, match="cuda"):
        ckpt.restore(str(tmp_path / "card"), params)
    with pytest.raises(ValueError, match="cuda"):
        RoundRNG(3, "cpu").load_state(card)

    # the streams continue where the saved run's would
    rng.next_round()
    ids = torch.randperm(10, generator=rng.host)
    saved = rng.state_dict()
    want = (torch.randperm(10, generator=rng.host),
            torch.randn(4, generator=rng.noise), rng.next_round())
    other = RoundRNG(3, "cpu")
    # a fresh run draws round 1's ids again, not the saved run's next ones
    assert torch.equal(torch.randperm(10, generator=other.host), ids)
    assert not torch.equal(ids, want[0])
    other.load_state(saved)
    got = (torch.randperm(10, generator=other.host),
           torch.randn(4, generator=other.noise), other.next_round())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2] == want[2] == 2
    # a round saved again replaces its directory and sidecar
    ckpt.save(d, 1, params, rng.state_dict(), 5.0)
    assert ckpt.digest_valid(d, 1) is True
    assert ckpt.restore(d, params)[3] == 5.0
