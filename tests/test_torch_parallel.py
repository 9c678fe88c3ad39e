"""The port's data-parallel pieces in one process, against the JAX package:

- the loader's per-process slice: ``_local_batches``, ``real_batch_size``
  and ``len`` equal the JAX ``DataLoader``'s index for index (1–4 shards,
  shuffle, ``drop_last``, a ragged final batch, weighted sampling), and the
  batches it yields are those rows;
- the fsdp rule equals JAX ``mesh._fsdp_spec`` on a table of shapes;
- ``create_mesh``'s errors, the launch variables, the launcher's refusal to
  re-run a command line that is not the run's;
- global draws: W ranks' slices of the crop, flip, ``t`` and noise draws are
  the one-process draws for the global batch; dropout seeds differ by rank.

The two-process runs are in ``tests/test_torch_multiprocess.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from stain2stain_tpu.data.base import DataLoader as JaxDataLoader
from stain2stain_tpu.parallel.mesh import _fsdp_spec
from stain2stain_tpu_torch.data.base import DataLoader, Dataset
from stain2stain_tpu_torch.ops.cfm import ConditionalFlowMatcher
from stain2stain_tpu_torch.ops.dropout import draw_seed
from stain2stain_tpu_torch.ops.image import paired_random_crop_flip
from stain2stain_tpu_torch.parallel import create_mesh, shard_batch, shard_chunk, sharded_generator
from stain2stain_tpu_torch.parallel import distributed as tdist
from stain2stain_tpu_torch.parallel.launch import launch_processes, requested_devices
from stain2stain_tpu_torch.parallel.mesh import fsdp_axis, fsdp_placements


class Indices(Dataset):
    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int) -> tuple:
        return (np.full((2,), idx, np.int64),)


LOADER_CASES = [
    dict(n=23, batch_size=8, shuffle=False, drop_last=False),  # ragged final batch of 7
    dict(n=23, batch_size=8, shuffle=True, drop_last=False),
    dict(n=23, batch_size=8, shuffle=True, drop_last=True),
    dict(n=13, batch_size=12, shuffle=False, drop_last=False),  # a final batch of 1
    dict(n=30, batch_size=12, shuffle=True, drop_last=False, weighted=True),
]


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
@pytest.mark.parametrize("case", LOADER_CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_local_batches_equal_jax_loader(case, shards):
    case = dict(case)
    n = case.pop("n")
    if case["batch_size"] % shards:
        case["batch_size"] = case["batch_size"] // shards * shards
    weights = np.linspace(1.0, 3.0, n) if case.pop("weighted", False) else None
    for index in range(shards):
        kw = dict(case, seed=11, num_workers=1, sampler_weights=weights, shard_index=index, num_shards=shards)
        port, ref = DataLoader(Indices(n), **kw), JaxDataLoader(Indices(n), **kw)
        assert len(port) == len(ref)
        assert (port.batch_size, port.global_batch_size) == (ref.batch_size, ref.global_batch_size)
        for epoch in (0, 3):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = port._local_batches(), ref._local_batches()
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            assert [port.real_batch_size(b) for b in range(len(port))] == [
                ref.real_batch_size(b) for b in range(len(ref))]
        yielded = [b[0][:, 0] for b in port]
        for g, w in zip(yielded, port._local_batches()):
            np.testing.assert_array_equal(g, w)


def test_loader_refuses_a_global_batch_the_processes_do_not_divide():
    with pytest.raises(ValueError, match="divisible by process count 4"):
        DataLoader(Indices(16), batch_size=6, num_shards=4)


SHAPES = [(), (3,), (1024,), (2048,), (1023,), (2048, 16), (16, 2048), (1026, 4), (3, 3, 512, 1024),
          (3, 3, 1024, 1024), (1024, 1024), (4096, 3), (6, 1030), (1536, 1536, 2)]


@pytest.mark.parametrize("fsdp", [2, 4])
@pytest.mark.parametrize("min_size", [1024, 8])
def test_fsdp_rule_equals_jax_fsdp_spec(fsdp, min_size):
    for shape in SHAPES:
        spec = _fsdp_spec((), np.zeros(shape, np.int8), fsdp, min_size)
        want = list(spec).index("fsdp") if "fsdp" in tuple(spec) else None
        assert fsdp_axis(shape, fsdp, min_size) == want, shape
        placement = fsdp_placements(shape, fsdp, min_size)[1]
        assert (placement.is_shard(want) if want is not None else placement.is_replicate()), shape


@pytest.mark.parametrize("num_devices,fsdp", [(4, 3), (2, 0), (6, 4)])
def test_create_mesh_refuses_an_fsdp_that_does_not_divide(num_devices, fsdp):
    with pytest.raises(ValueError, match="not divisible by fsdp"):
        create_mesh(num_devices, fsdp=fsdp)


def test_create_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        create_mesh(1, fsdp=1)


def test_shard_batch_and_chunk_take_strided_rows():
    batch = (np.arange(12).reshape(6, 2), torch.arange(6))
    rows = shard_batch(None, batch, index=1, count=3)
    np.testing.assert_array_equal(rows[0], batch[0][1::3])
    assert torch.equal(rows[1], torch.tensor([1, 4]))
    chunk = np.arange(24).reshape(2, 6, 2)
    np.testing.assert_array_equal(shard_chunk(None, chunk, index=2, count=3), chunk[:, 2::3])


def test_launch_variables(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "COORDINATOR_ADDRESS",
                "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    assert tdist.launch_config() is None
    assert tdist.maybe_initialize_distributed() is False  # no variables: one process, no group
    assert (tdist.process_index(), tdist.process_count(), tdist.launch_rank()) == (0, 1, 0)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("NUM_PROCESSES", "4")
    monkeypatch.setenv("PROCESS_ID", "3")
    assert tdist.launch_config() == (3, 4, "tcp://10.0.0.1:1234")
    assert tdist.launch_rank() == 3
    for key, value in (("RANK", "1"), ("WORLD_SIZE", "2"), ("MASTER_ADDR", "h"), ("MASTER_PORT", "9")):
        monkeypatch.setenv(key, value)
    assert tdist.launch_config() == (1, 2, "env://")  # torchrun's take precedence


def test_launcher_starts_nothing_for_one_device_or_a_foreign_command_line(monkeypatch, caplog):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(key, raising=False)
    assert [requested_devices(d) for d in ("auto", -1, 1, 3, [0, 1])] == [1, 1, 1, 3, 2]
    assert launch_processes({"devices": 1, "accelerator": "cpu"}, command_line=True) == []
    assert launch_processes({"devices": 2, "accelerator": "cpu"}, command_line=False) == []
    assert "not starting processes" in caplog.text


@pytest.mark.parametrize("world", [2, 4])
def test_draws_are_global_batch_draws_sliced(world):
    full = 8
    ref = sharded_generator(5)
    x = torch.zeros(full, 12, 12, 1)
    want_crop = paired_random_crop_flip([x + torch.arange(full)[:, None, None, None]], 8, generator=ref)[0]
    want_t = ConditionalFlowMatcher(sigma=0.1).sample_t(full, ref)
    want_xt = ConditionalFlowMatcher(sigma=0.1).sample_xt(x, x, want_t, generator=ref)
    for rank in range(world):
        gen = sharded_generator(5, (rank, world))
        local = (x + torch.arange(full)[:, None, None, None])[rank::world]
        crop = paired_random_crop_flip([local], 8, generator=gen)[0]
        t = ConditionalFlowMatcher(sigma=0.1).sample_t(full // world, gen)
        xt = ConditionalFlowMatcher(sigma=0.1).sample_xt(x[rank::world], x[rank::world], t, generator=gen)
        assert torch.equal(crop, want_crop[rank::world])
        assert torch.equal(t, want_t[rank::world])
        assert torch.equal(xt, want_xt[rank::world])
        assert gen.get_state().equal(ref.get_state())  # every rank advanced its generator alike


def test_dropout_seed_keeps_rank_0_and_differs_by_rank():
    seeds = [draw_seed(sharded_generator(9, (rank, 4))) for rank in range(4)]
    assert seeds[0] == draw_seed(torch.Generator().manual_seed(sharded_generator(9).initial_seed()))
    assert len(set(seeds)) == 4
