"""The check catches what it should: a run of each cell at a small size on
the CPU (the harness's look for a card skipped, the rest of a run driven as
``run.py`` drives it) is correct as it stands, and not correct with each
fault of its driver (``FAULTS``) planted under its timed path, nor with a
lower-precision control in the program's place.  The same controls at the
cells' own size run on the card (marked ``cuda``)."""

import pytest
import torch

from benchmark import calibrate, cell as cells, check, drivers, run

H, W = 48, 64
SECONDS = 0.3
CELLS = [w["name"] for w in cells.load_spec()["workloads"]]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def driver_of(cell_name):
    return drivers.load(cells.resolve(cells.load_spec(), cell_name)
                        .config["entry"])


def small(cell_name, **changes):
    c = cells.resolve(cells.load_spec(), cell_name)
    c.config = dict(c.config, width=W, height=H, **changes)
    return c


def correct(c, seed=17):
    return run.run_cell(c, seed, SECONDS, False, "cpu")["result"]["correct"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_sound_run_is_correct(cell_name):
    assert correct(small(cell_name))


@pytest.mark.parametrize("cell_name,fault", [
    (c, f) for c in CELLS for f in driver_of(c).FAULTS])
def test_a_planted_fault_is_not_correct(cell_name, fault):
    c = small(cell_name)
    with driver_of(cell_name).FAULTS[fault]():
        assert not correct(c)


@pytest.mark.parametrize("cell_name,control", [
    (c, k) for c in CELLS for k in driver_of(c).PROGRAM_CONTROLS])
def test_the_programs_bf16_sweep_is_not_correct(cell_name, control):
    changes = driver_of(cell_name).PROGRAM_CONTROLS[control]
    assert not correct(small(cell_name, **changes))


def control_verdict(c, seed, device):
    d, _ = calibrate.measure(c, seed, SECONDS, device)
    mod = drivers.load(c.config["entry"])
    ok, rows = check.verdict(mod.control_numbers(d), c.config["limits"])
    return ok, rows


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_reference_in_bf16_is_not_correct(cell_name):
    ok, rows = control_verdict(small(cell_name), 23, "cpu")
    assert not ok, rows


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_controls_at_the_cells_size_on_the_card(cell_name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's "
                    "own size")
    c = cells.resolve(cells.load_spec(), cell_name)
    for seed in (101, 202, 303):
        ok, rows = control_verdict(c, seed, "cuda")
        assert not ok, rows
        for changes in driver_of(cell_name).PROGRAM_CONTROLS.values():
            _, numbers = calibrate.measure(c, seed, 1.0, "cuda",
                                           dict(c.config, **changes))
            assert not check.verdict(numbers, c.config["limits"])[0]
