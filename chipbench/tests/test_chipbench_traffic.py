"""The traffic generator: a pure function of the seed and the traffic
file's parameters."""
import json

import numpy as np
import pytest

from chipbench.harness import traffic as gen

from .tiny import REPO

SEEDS = [0, 7, 2**31 + 5, 2**40 + 3]


def load(name):
    return json.loads((REPO / "chipbench" / "traffic" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("seed", SEEDS)
def test_token_stream_repeats_for_a_seed_with_the_same_sizes(seed):
    p = load("train.top2")
    a, b = gen.LMStream(p, 151936, seed), gen.LMStream(p, 151936, seed)
    other = gen.LMStream(p, 151936, seed + 1)
    for step in (0, 1, 17):
        x, y = a(step), b(step)
        assert set(x) == {"tokens", "labels"}
        for k in x:
            assert np.array_equal(x[k], y[k])
            assert x[k].shape == (p["batch"], p["seq_len"])
            assert x[k].dtype == np.int32
        assert not np.array_equal(x["tokens"], other(step)["tokens"])
        assert np.array_equal(x["labels"], np.roll(x["tokens"], -1, axis=1))
        assert x["tokens"].min() >= 0 and x["tokens"].max() < 151936
        # every row differs: no two rows of a step are alike
        assert len({r.tobytes() for r in x["tokens"]}) == p["batch"]
    assert not np.array_equal(a(0)["tokens"], a(1)["tokens"])


@pytest.mark.parametrize("seed", SEEDS)
def test_conversations_share_the_system_prompt_and_repeat(seed):
    p = load("serve.prefix")
    a, b = gen.Conversations(p, 49155, seed), \
        gen.Conversations(p, 49155, seed)
    shared = p["shared_prefix_tokens"]
    prompts = [a(s, t) for s in range(p["sessions"]) for t in range(3)]
    for s in range(p["sessions"]):
        assert np.array_equal(a(s, 2), b(s, 2))
    for x in prompts:
        assert x.shape == (p["requests"], p["prompt_tokens"])
        assert x.dtype == np.int32 and x.max() < 49155
        assert np.array_equal(x[:, :shared],
                              np.broadcast_to(prompts[0][0, :shared],
                                              x[:, :shared].shape))
    own = {x[r, shared:].tobytes() for x in prompts
           for r in range(p["requests"])}
    assert len(own) == len(prompts) * p["requests"]
    assert not np.array_equal(a(0, 0), gen.Conversations(p, 49155,
                                                         seed + 1)(0, 0))


def test_no_shared_prefix_is_a_data_change():
    p = dict(load("serve.prefix"), shared_prefix_tokens=0)
    c = gen.Conversations(p, 100, 3)
    assert c(0, 0).shape == (p["requests"], p["prompt_tokens"])
    with pytest.raises(ValueError):
        gen.Conversations(dict(p, shared_prefix_tokens=99), 100, 3)


def test_sample_is_drawn_from_the_seed():
    assert gen.sample(5, 1, 100, 8) == gen.sample(5, 1, 100, 8)
    assert gen.sample(5, 1, 100, 8) != gen.sample(6, 1, 100, 8)
    assert gen.sample(5, 1, 3, 8) == [0, 1, 2]
    assert len(set(gen.sample(2**31 + 9, 4, 50, 10))) == 10


def test_trained_and_frozen_prefixes():
    trained = gen.trained_prefixes({"top_layers": 2, "final_norm": True},
                                   24)
    assert trained == ["layers/22", "layers/23", "final_norm"]
    frozen = gen.frozen_prefixes(trained, ["embed", "final_norm", "layers"],
                                 24)
    assert frozen == ["embed"] + [f"layers/{i}" for i in range(22)]
    every = gen.trained_prefixes({"top_layers": "all", "embed": True}, 3)
    assert gen.frozen_prefixes(every, ["embed", "final_norm", "layers"],
                               3) == []
