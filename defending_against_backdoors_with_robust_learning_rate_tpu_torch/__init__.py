"""PyTorch / CUDA port of the robust-learning-rate federated-learning
simulator, for one NVIDIA H100.

The JAX package `defending_against_backdoors_with_robust_learning_rate_tpu`
beside this one is the reference: every module here names its counterpart
there, and the tests hold each against it. This package imports torch and
numpy only, never jax, flax or the JAX package.

Slice 1 ports the paper's headline path (FMNIST, CNN_MNIST, K=10 agents,
FedAvg with the RLR vote):

    config.py   the main-path flags of the JAX CLI
    data/       synthetic + FMNIST idx data, label-sorted partition, stacks
    attack/     trojan stamps + poisoning
    models/     CNN_MNIST / CNN_CIFAR (NCHW) + the Flax weight carrier
    ops/        sgd/clip/PGD, aggregation rules, the RLR server kernels
    fl/         local training, the round, eval
    utils/      run name + JSONL metrics
    train.py    the round loop and `main(argv)`

Slice 2 ports the sharded round and the in-round health lanes:

    parallel/   the `agents` process group, the multi-card launch, the
                sharded round with the per-rank partial-vote kernel
    health/     the in-round health lanes

Slice 6 ports the remaining server rules and the fault model:

    ops/aggregate.py  comed, trmean, krum, rfa, each with a mask
    faults/           the fault draw and payload checks (model.py), the
                      participation mask through every rule (masking.py)
    health/sentinel.py the quarantine set (--quarantine), ANDed into the
                      participation mask of the device-resident round
    health/monitor.py the health policy at each eval boundary
    utils/guards.py   the boundary's finite check

Slice 9 ports the population axis:

    data/bank.py      the sharded, memory-mapped client bank (label_shards,
                      dirichlet, pathological)
    data/cohort.py    the seeded per-round cohort draw
    data/traffic.py   diurnal presence
    service/churn.py  churn lifecycles
    utils/streams.py  the counter-based host stream those draws use
    fl/rounds.py      the cohort-sampled round and the chained host round

Hand-written kernel sources live in `csrc/` and are built on first use into
`build/torch_ext/` at the repository root.
"""

__version__ = "0.1.0"
