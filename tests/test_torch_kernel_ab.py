"""The cases of ``utils/kernel_ab.py`` on the CPU, at a small frame.

On the card the script holds this tree's kernels against another tree's
bit for bit.  Here each case's launch runs through the wrappers, which
take their plain twins for CPU tensors: this checks that every case
builds its inputs and calls its wrapper with the arguments the wrapper
takes (K14 whole frame and tile form, K8 on each scene, KGb), and that the
outputs are finite and of the expected shapes.  No timing, no other tree.
"""

import re

import pytest
import torch

from raymarchdenoisercuda_torch.utils import kernel_ab

FRAME = (24, 40)


@pytest.fixture(scope="module")
def inputs():
    threads, frame = torch.get_num_threads(), kernel_ab.FRAME
    torch.set_num_threads(1)
    kernel_ab.FRAME = FRAME
    H, W = FRAME
    dev = torch.device("cpu")
    g = torch.Generator(dev).manual_seed(11)
    cots = (torch.randn((3, H, W), generator=g),
            torch.randn((H, W), generator=g))
    U = kernel_ab.planes(2 * H, 2 * W, dev, 12) + ((
        torch.randn((3, 2 * H, 2 * W), generator=g),
        torch.randn((2 * H, 2 * W), generator=g)),)
    with torch.no_grad():
        S = kernel_ab.shade_inputs(dev)
    yield kernel_ab.planes(H, W, dev, 0), U, cots, S
    torch.set_num_threads(threads)
    kernel_ab.FRAME = frame


# (name pattern, expected number of cases, output shapes of the first)
FAMILIES = {
    "K14": (r"^K14 ", 20, [(3, *FRAME), FRAME]),
    "K14 tile": (r"^tile K14 ", 4, [(3, 28, 44), (28, 44)]),
    "K8": (r"^K8 ", 15, [(3, *FRAME), FRAME, (2, *FRAME)]),
    "KGb": (r"^KGb", 1, [(10, *FRAME), (2, *FRAME)]),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_kernel_ab_cases_run_on_the_cpu(inputs, family):
    pattern, n, shapes = FAMILIES[family]
    this = kernel_ab.Tree(kernel_ab.PACKAGE)
    found = [(name, make, exact)
             for name, make, exact in kernel_ab.cases(*inputs)
             if re.search(pattern, name)]
    assert len(found) == n
    with torch.no_grad():
        for k, (name, make, exact) in enumerate(found):
            out = make(this)()
            assert exact == (family != "KGb"), name
            assert all(bool(torch.isfinite(x.float()).all()) for x in out), \
                name
            if k == 0:
                assert [tuple(x.shape) for x in out] == shapes, name
