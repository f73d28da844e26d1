"""rfnet_tpu_torch/checkpoints.py and the network table of models/__init__.py:
every network of the table loads back from its saved weights, by its keys
alone and by its name, and a network registered in the table is served with
no other edit; the trainer's best record and the forms a served path takes.
"""

import os

import pytest
import torch

from rfnet_tpu_torch import checkpoints, models

# each network of the table at a small size: (the sizes its weights hold,
# the sizes they do not)
SMALL = {
    "rfnet": (dict(n_seed=4, up_ratio=4), dict(input_points=64)),
    "snowflakenet": (dict(num_pc=32, up_factors=(2, 2)),
                     dict(num_p0=64, sa_points=(64, 16), input_points=256)),
}


def _equal_weights(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def test_the_table_holds_every_small_network():
    assert set(SMALL) == set(models.MODELS) and models.DEFAULT in models.MODELS


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_network_loads_back_by_its_keys_and_by_its_name(name, tmp_path):
    held, other = SMALL[name]
    net = models.MODELS[name](generator=torch.Generator().manual_seed(5), **held, **other)
    path = str(tmp_path / "weights.pt")
    torch.save(net.state_dict(), path)
    x = torch.rand(2, net.input_points, 3, generator=torch.Generator().manual_seed(6)) - 0.5
    with torch.inference_mode():
        want = net.eval()(x).out4
    assert want.shape == (2, net.output_points, 3)
    assert models.network_of(net.state_dict()) == name
    for by in (None, name):
        got = checkpoints.load_state(path, model=by, sizes=other).eval()
        assert type(got) is type(net) and _equal_weights(got, net)
        assert (got.input_points, got.output_points) == (net.input_points, net.output_points)
        with torch.inference_mode():
            assert torch.equal(got(x).out4, want)
    for wrong in set(models.MODELS) - {name}:
        with pytest.raises(SystemExit, match=f"holds {type(net).__name__} weights"):
            checkpoints.load_state(path, model=wrong)
    with pytest.raises(SystemExit, match="--model nonet: one of"):
        checkpoints.load_state(path, model="nonet")


class Toy(torch.nn.Module):
    """A network of the table's protocol, with nothing of its own anywhere
    else: its weights name ``toy.weight``, which holds its width."""

    KEY = "toy.weight"

    def __init__(self, width: int = 3, input_points: int = 8,
                 generator: torch.Generator | None = None, dtype: torch.dtype | None = None):
        super().__init__()
        self.toy = torch.nn.Linear(3, width)
        with torch.no_grad():
            for p in self.toy.parameters():
                p.uniform_(-1, 1, generator=generator)
        self.input_points = self.output_points = input_points

    @classmethod
    def for_weights(cls, state_dict, sizes=None, dtype=None):
        return cls(width=state_dict["toy.weight"].shape[0], dtype=dtype, **(sizes or {}))


def test_a_network_registered_in_the_table_is_served(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(models.MODELS, "toy", Toy)
    net = Toy(width=5, generator=torch.Generator().manual_seed(1))
    path = str(tmp_path / "toy.pt")
    torch.save(net.state_dict(), path)
    for by in (None, "toy"):
        got = checkpoints.load_state(path, model=by, sizes=dict(input_points=12))
        assert type(got) is Toy and got.toy.out_features == 5 and got.input_points == 12
        assert _equal_weights(got, net)
    with pytest.raises(SystemExit, match="holds Toy weights, not --model rfnet's"):
        checkpoints.load_state(path, model="rfnet")
    fresh = checkpoints.load_state(str(tmp_path / "none"), model="toy")
    assert type(fresh) is Toy and "evaluating random init" in capsys.readouterr().out
    seeded = Toy(generator=torch.Generator().manual_seed(checkpoints.RANDOM_INIT_SEED))
    assert _equal_weights(fresh, seeded)


def test_the_best_record_and_the_forms_of_a_served_path(tmp_path):
    held, _ = SMALL["rfnet"]
    model = models.RFNet(**held)
    work = str(tmp_path / "run" / "work")
    record = checkpoints.best_record(work)
    assert checkpoints.read_best(record)[0] == float("inf")
    assert checkpoints.weights_file(record) is None
    checkpoints.save_best(record, model, 6, 0.25)
    cd, meta = checkpoints.read_best(record)
    assert cd == 0.25 and os.path.isfile(meta) and checkpoints.is_best_record(record)
    assert checkpoints.stored_step(record) == 6
    assert os.path.samefile(checkpoints.weights_file(record),
                            os.path.join(tmp_path, "run", "bestrecord", "model.pt"))
    assert checkpoints.stored_step(os.path.join(work, "ckpt_12.pt")) == 12
    assert checkpoints.weights_file(work) is None and checkpoints.list_checkpoints(work) == []
    assert _equal_weights(checkpoints.load_state(record), model)
