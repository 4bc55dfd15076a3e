"""The update attack on the port's other round paths: the sharded round
(parallel/rounds.py) and the host-sampled round (fl/rounds.
make_round_fn_host), each against the dense round that
tests/test_torch_attack_round.py holds against JAX.

(a) the sharded round at d = 2, on gloo thread ranks
(parallel/mesh.run_in_threads: no process, no port), under `--attack
signflip` (and boost), equals the dense round for the same ids and
draws, with the plan's 3 all_reduces a round: each rank scales its own
block of rows, which adds no collective. (b) the host-sampled round under
boost equals the device-resident round on the same ids; and with
`--payload_norm_cap`, the boosted rows fail the payload check (the attack
comes before it, JAX fl/rounds.py:273-292), so the round equals one that
leaves the corrupt agents out of the vote.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import numpy as np
import pytest
import torch

from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.fl import (
    common, rounds)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.models import (
    registry)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.ops import (
    tree)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel import (
    multihost)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.mesh import (
    run_in_threads)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.parallel.rounds import (
    make_sharded_round_fn)

SHAPE = (14, 14, 1)
BS, N_TOTAL = 16, 48
SIZES = [48, 40, 33, 17]    # full / partial / partial / fully padded batches
SAMPLED = [2, 0, 3, 1]      # corrupt ids 0 and 1: slot 1 on rank 0, slot 3
                            # on rank 1
KW = dict(data="fmnist", num_agents=4, bs=BS, local_ep=2, client_lr=0.1,
          client_moment=0.9, num_corrupt=2, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _setup():
    rng = np.random.default_rng(42)
    xs = torch.from_numpy(rng.uniform(0, 255, size=(len(SIZES), N_TOTAL)
                                      + SHAPE).astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, 10, size=(len(SIZES), N_TOTAL)))
    perms = [[torch.from_numpy(np.concatenate([
        rng.permutation(SIZES[a]), np.arange(SIZES[a], N_TOTAL)]))
        for _ in range(KW["local_ep"])] for a in SAMPLED]
    model = registry.get_model("fmnist", SHAPE)
    return dict(xs=xs, ys=ys, perms=perms, model=model,
                norm=common.make_normalizer((0.5,), (0.5,), "cpu"),
                params=registry.init_params(model, 3, "cpu"),
                sizes=np.asarray(SIZES, np.int32))


def _flat(params):
    return np.concatenate([v.detach().numpy().ravel()
                           for v in params.values()])


def test_sharded_attacked_round_matches_dense():
    st = _setup()
    cases = [  # (attack kw, aggr, thr, fused, injected draws)
        (dict(attack="signflip"), "avg", 2, True, True),
        (dict(attack="signflip", attack_boost=3.0), "sign", 2, False, True),
        (dict(attack="signflip"), "avg", 2, False, False),
        (dict(attack="boost", attack_boost=8.0), "avg", 2, True, True)]
    for atk, aggr, thr, fused, injected in cases:
        cfg = Config(**KW, **atk, aggr=aggr, robustLR_threshold=thr,
                     use_fused=fused)
        kw = (dict(sampled=SAMPLED, perms=st["perms"], dropout=False)
              if injected else {})
        dense, dinfo = rounds.make_round_fn(
            cfg, st["model"], st["norm"], st["xs"], st["ys"], st["sizes"])(
                st["params"], rounds.RoundRNG(5, "cpu"), **kw)
        clean, _ = rounds.make_round_fn(
            cfg.replace(attack="static"), st["model"], st["norm"], st["xs"],
            st["ys"], st["sizes"])(st["params"], rounds.RoundRNG(5, "cpu"),
                                   **kw)
        # the attack is live on the dense round
        assert np.abs(_flat(dense) - _flat(clean)).max() > 1e-3

        def rank(group, cfg=cfg, kw=kw):
            round_fn = make_sharded_round_fn(
                cfg, registry.get_model("fmnist", SHAPE), st["norm"], group,
                st["xs"], st["ys"], st["sizes"])
            before = group.calls
            new, info = round_fn(st["params"], rounds.RoundRNG(5, "cpu"),
                                 **kw)
            return new, info, group.calls - before

        what = f"{atk} {aggr} thr={thr} fused={fused} injected={injected}"
        for new, info, calls in run_in_threads(2, rank):
            assert info["sampled"] == dinfo["sampled"], what
            # the plan's all_reduces, 3 for avg and 2 for sign: the attack
            # adds none
            assert calls == multihost.leaf_plan_collectives(cfg), what
            assert calls == (3 if aggr == "avg" else 2), what
            for k in st["params"]:
                # tests/test_torch_sharded.py's tolerance: the same local
                # training, the server step's sums in another order
                np.testing.assert_allclose(
                    new[k].numpy(), dense[k].numpy(), atol=1e-5, rtol=1e-5,
                    err_msg=f"{what} {k}")
            np.testing.assert_allclose(float(info["train_loss"]),
                                       float(dinfo["train_loss"]),
                                       rtol=1e-4, err_msg=what)
            # the lanes of the attacked stack, packed into the loss
            # all_reduce: 1e-5
            np.testing.assert_allclose(float(info["hlth_update_normsq"]),
                                       float(dinfo["hlth_update_normsq"]),
                                       rtol=1e-5, err_msg=what)

    # the sharded round refuses what it does not run yet (the telemetry
    # is ported: tests/test_torch_sharded_telemetry.py)
    group = type("G", (), {"size": 2, "rank": 0})()
    for kw in (dict(diagnostics=True), dict(reputation="on")):
        with pytest.raises(ValueError, match="not ported yet"):
            make_sharded_round_fn(Config(**KW, telemetry="full", **kw), None,
                                  None, group, None, None, None)


def test_host_round_and_payload_cap_under_boost():
    st = _setup()
    cfg = Config(**KW, attack="boost", attack_boost=8.0, agent_frac=1.0,
                 robustLR_threshold=2)
    ids = SAMPLED
    imgs, lbls = st["xs"][ids], st["ys"][ids].long()
    slot_sizes = torch.from_numpy(st["sizes"][ids])
    dense = rounds.make_round_fn(cfg, st["model"], st["norm"], st["xs"],
                                 st["ys"].long(), st["sizes"])
    host = rounds.make_round_fn_host(cfg, st["model"], st["norm"],
                                     st["sizes"], N_TOTAL, "cpu")
    p_dense, i_dense = dense(st["params"], rounds.RoundRNG(5, "cpu"),
                             sampled=ids)
    p_host, i_host = host(st["params"], rounds.RoundRNG(5, "cpu"), ids, imgs,
                          lbls, slot_sizes)
    scale = np.abs(_flat(p_dense) - _flat(st["params"])).max()
    assert scale > 1e-3
    # test_torch_host.py's tolerance: the same kernels on the same rows
    np.testing.assert_allclose(_flat(p_host), _flat(p_dense), rtol=0,
                               atol=1e-6 * scale)
    assert float(i_host["hlth_update_normsq"]) == pytest.approx(
        float(i_dense["hlth_update_normsq"]), rel=1e-6)

    # the payload check sees the boosted rows: a cap above every honest
    # norm and below every boosted one masks exactly the corrupt slots
    updates, _ = rounds.make_block_trainer(
        cfg, st["model"], st["norm"], st["xs"], st["ys"].long(),
        st["sizes"])(st["params"], rounds.RoundRNG(5, "cpu"), 1, ids, 0,
                     len(ids))
    norms = tree.norm_rows(updates).numpy()
    corrupt = np.asarray(ids) < cfg.num_corrupt
    honest_max, corrupt_min = norms[~corrupt].max(), norms[corrupt].min()
    assert 8 * corrupt_min > 2 * honest_max
    cap = float(np.sqrt(honest_max * 8 * corrupt_min))
    capped = cfg.replace(payload_norm_cap=cap)
    p_cap, i_cap = rounds.make_round_fn(
        capped, st["model"], st["norm"], st["xs"], st["ys"].long(),
        st["sizes"])(st["params"], rounds.RoundRNG(5, "cpu"), sampled=ids)
    assert float(i_cap["fault_voters"]) == float((~corrupt).sum())
    # the same round with the corrupt agents quarantined and no attack
    quarantined = capped.replace(attack="static", attack_boost=1.0,
                                 quarantine="0,1")
    p_q, i_q = rounds.make_round_fn(
        quarantined, st["model"], st["norm"], st["xs"], st["ys"].long(),
        st["sizes"])(st["params"], rounds.RoundRNG(5, "cpu"), sampled=ids)
    assert float(i_q["fault_voters"]) == float(i_cap["fault_voters"])
    for k, v in p_cap.items():
        assert torch.equal(v, p_q[k]), k
    # without the cap the boosted rows vote
    assert np.abs(_flat(p_cap) - _flat(p_dense)).max() > 1e-3
