"""Placement of the port's sharded ranks (``raptor_tpu_torch.parallel.
comm``): ``rank_devices`` maps each rank to its device (NCCL: rank r on
``cuda:r``; gloo: the one device given, shared), ``spawn`` refuses a
placement NCCL cannot run before any process starts, hands every rank body
its device and ends a run whose rank fails while the others wait; and the
CLI's choice of ranks for ``bench --preset config5``.  No JAX and no card:
the NCCL runs themselves are the two-card ``cuda`` tests in
tests/test_torch_cuda.py.  Spawned bodies are in
tests/_torch_multicard_spmd.py."""

import time

import pytest
import torch

from raptor_tpu_torch.cli import config5_ranks
from raptor_tpu_torch.parallel import comm, rank_devices, spawn
from tests import _torch_multicard_spmd


@pytest.mark.parametrize("world,cards", [(1, 1), (2, 2), (4, 4), (2, 8)])
def test_nccl_puts_rank_r_on_card_r(world, cards):
    for dev in ("cuda", torch.device("cuda")):
        assert rank_devices("nccl", dev, world, cards) == [
            torch.device("cuda", r) for r in range(world)]


@pytest.mark.parametrize("device", ["cpu", "cuda:0", "cuda"])
def test_gloo_shares_the_given_device(device):
    assert rank_devices("gloo", device, 4, 1) == [torch.device(device)] * 4


def test_a_list_names_each_ranks_device():
    assert rank_devices("nccl", ["cuda:2", "cuda:0"], 2, 4) == [
        torch.device("cuda", 2), torch.device("cuda", 0)]
    assert rank_devices("gloo", ["cpu", "cuda:1"], 2, 0) == [
        torch.device("cpu"), torch.device("cuda", 1)]


@pytest.mark.parametrize("device,world,cards,words", [
    ("cuda", 4, 2, ["4 NCCL ranks", "2 visible"]),
    ("cuda", 2, 0, ["2 NCCL ranks", "0 visible"]),
    ("cuda:1", 2, 4, ["one rank a card"]),
    (["cuda:1", "cuda:1"], 2, 4, ["one rank a card"]),
    (["cuda:0", "cuda:4"], 2, 4, ["card 4", "4 visible"]),
    ("cpu", 2, 4, ["CUDA devices"]),
    (["cuda:0"], 2, 4, ["1 devices given for 2 ranks"]),
])
def test_placements_nccl_cannot_run_raise(device, world, cards, words):
    with pytest.raises(ValueError) as err:
        rank_devices("nccl", device, world, cards)
    for w in words:
        assert w in str(err.value)


def test_spawn_refuses_before_any_process_starts(monkeypatch):
    """Two NCCL ranks on a machine without two cards: ValueError at once,
    naming both numbers; no process is started."""
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        pytest.skip(f"{n_cards} cards visible: two NCCL ranks would run")

    def started(*args, **kwargs):
        raise AssertionError("a process was started")

    monkeypatch.setattr(comm.mp, "start_processes", started)
    with pytest.raises(ValueError, match=f"2 NCCL ranks need 2 cards, "
                                         f"{n_cards} visible"):
        spawn(_torch_multicard_spmd.placement, 2, "nccl", "cuda")


@pytest.mark.parametrize("device", ["cpu", ["cpu", "cpu"]])
def test_rank_bodies_get_the_resolved_device(device):
    """Two gloo ranks on the CPU: each body gets the device spawn resolved
    for it, its rank, and the host-staged ring."""
    out = spawn(_torch_multicard_spmd.placement, 2, "gloo", device,
                timeout=120.0)
    assert out == [{"device": "cpu", "rank": r, "size": 2, "host_staged": True,
                    "current": None} for r in range(2)]


def test_a_failing_rank_ends_the_run_while_the_others_wait():
    """The last rank raises while rank 0 waits in a psum it never enters:
    spawn raises the rank's error well within the run's limit."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="the last rank fails on purpose"):
        spawn(_torch_multicard_spmd.fail_on_last, 2, "gloo", "cpu",
              timeout=120.0)
    assert time.monotonic() - t0 < 60.0


@pytest.mark.parametrize("n,cards,ranks", [
    (256, 1, 1), (256, 2, 2), (256, 4, 4), (256, 3, 1), (256, 8, 8),
    (100, 8, 1), (96, 3, 3), (16, 0, 1)])
def test_cli_config5_shards_over_every_card_that_divides_n(n, cards, ranks):
    """The reference's rule (raptor_tpu/cli.py:215-218): every visible
    card when n divides over them, else one device."""
    assert config5_ranks(n, cards) == ranks
