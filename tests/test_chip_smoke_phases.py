"""chip_smoke.py's phases at toy sizes, called directly on the CPU: the
device side and the comparison side are then both the host, so every gate
must pass with room to spare."""

import importlib.util
import pathlib

import jax
import pytest

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).parent.parent / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

PHASES = {
    "macenko": lambda: cs.phase_extractive("macenko", n=2, size=64, n_ref=1),
    "vahadane": lambda: cs.phase_extractive("vahadane", n=2, size=64, n_ref=1),
    "reinhard": lambda: cs.phase_reinhard(n=2, size=64, n_ref=1),
    "fixed_matrix": lambda: cs.phase_fixed_matrix(n=2, size=64, n_ref=1),
    "dropin": lambda: cs.phase_dropin(sizes=(63, 96), target_size=64),
    "augment": lambda: cs.phase_augment(n=2, size=64, pops=2),
    "pop_batch": lambda: cs.phase_pop_batch(n=2, size=64),
    "four_cards": lambda: cs.phase_four_cards(n_dev=4, n=8, size=32,
                                              n_pixels=1024),
}


@pytest.mark.parametrize("name", sorted(PHASES))
def test_phase_at_toy_size(name):
    if name == "four_cards" and jax.device_count() < 4:
        pytest.skip("needs 4 devices")
    ph = PHASES[name]()
    assert ph.ok, ph.line()
    line = ph.line()
    assert line.startswith(f"phase {ph.name} [") and line.endswith(" ok")
    assert "Precision.HIGHEST" in line


def test_phase_reports_failures():
    ph = cs.Phase("x", "shape")
    ph.gate("max_step", 3, 1, False)
    assert not ph.ok and "FAIL max_step=3 (limit 1)" in ph.line()
