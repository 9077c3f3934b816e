"""The port's copies of the configs, the data streams and the participation
sampler give exactly what the reference gives (bitwise)."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.configs as jcfg  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro.core.sampler import STRAGGLER_PROFILES as J_PROFILES  # noqa: E402
from repro.core.sampler import ParticipationConfig as JPC  # noqa: E402
from repro.core.sampler import plan_round as j_plan  # noqa: E402
from repro.data import build_client_streams as j_streams  # noqa: E402
from repro.data import round_batches as j_round_batches  # noqa: E402
from repro.data import validation_stream as j_val  # noqa: E402
from repro_torch.core.sampler import STRAGGLER_PROFILES as T_PROFILES  # noqa: E402
from repro_torch.core.sampler import ParticipationConfig as TPC  # noqa: E402
from repro_torch.core.sampler import plan_round as t_plan  # noqa: E402
from repro_torch.data import build_client_streams as t_streams  # noqa: E402
from repro_torch.data import round_batches as t_round_batches  # noqa: E402
from repro_torch.data import validation_stream as t_val  # noqa: E402

PHOTON = ["photon-75m", "photon-125m", "photon-350m", "photon-1.3b", "photon-3b", "photon-7b"]


@pytest.mark.parametrize("name", PHOTON)
def test_photon_configs_equal(name):
    j, t = jcfg.get_config(name), tcfg.get_config(name)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    for cj, ct in ((j, t), (j.reduced(), t.reduced())):
        assert cj.padded_vocab == ct.padded_vocab
        assert cj.param_count() == ct.param_count()
        assert [dataclasses.asdict(k) for k in cj.layer_kinds()] == [
            dataclasses.asdict(k) for k in ct.layer_kinds()
        ]


@pytest.mark.parametrize("heterogeneous", [False, True])
def test_round_batches_bitwise(heterogeneous):
    js = j_streams(6, 32, 512, heterogeneous=heterogeneous, seed=3)
    ts = t_streams(6, 32, 512, heterogeneous=heterogeneous, seed=3)
    sel = [4, 1, 5]
    for _ in range(2):
        a = j_round_batches([js[i] for i in sel], 3, 2)["tokens"]
        b = t_round_batches([ts[i] for i in sel], 3, 2)["tokens"]
        assert a.dtype == b.dtype and a.shape == b.shape == (3, 3, 2, 32)
        np.testing.assert_array_equal(a, b)
    assert [s.state_dict() for s in js] == [s.state_dict() for s in ts]
    np.testing.assert_array_equal(
        j_val(32, 512, heterogeneous).next_batch(4), t_val(32, 512, heterogeneous).next_batch(4)
    )


def _plan_fields(plan):
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}


@pytest.mark.parametrize("model", ["uniform", "dirichlet", "markov"])
@pytest.mark.parametrize("dropout", [0.0, 0.3])
@pytest.mark.parametrize("straggler", ["none", "heavy"])
@pytest.mark.parametrize("partial", [False, True])
def test_plan_round_bitwise(model, dropout, straggler, partial):
    kw = dict(population=12, clients_per_round=5, model=model, dropout_rate=dropout,
              weighting="examples", partial_progress=partial, local_steps=4 if partial else 0)
    jp = JPC(straggler=J_PROFILES[straggler], **kw)
    tp = TPC(straggler=T_PROFILES[straggler], **kw)
    for rnd in range(6):
        a, b = _plan_fields(j_plan(jp, 7, rnd)), _plan_fields(t_plan(tp, 7, rnd))
        assert a.keys() == b.keys()
        for k in a:
            if a[k] is None:
                assert b[k] is None, k
            elif isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
