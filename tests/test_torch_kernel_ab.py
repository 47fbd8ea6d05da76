"""The cases of ``utils/kernel_ab.py`` on the CPU, at a small frame.

On the card the script holds this tree's kernels against another tree's
bit for bit.  Here each case's launch runs through the wrappers, which
take their plain twins for CPU tensors: this checks that every case
builds its inputs and calls its wrapper with the arguments the wrapper
takes (K14 and K2/K2b whole frame and tile form, K7 unseeded, seeded
and on a window, K8 and K13 on each scene, K3 on every input kind, the
served frame's among them, K3b on the quarter tiles, KG and KGb on each
input and stack layout (KGb with each pair of gradients) and KG after the
served step's stack, K4, K5 and K6 on each motion and K4c, K5c and K6c on
the quarter tiles, K15 from the
camera, a quarter window and the ray planes and alone on each scene, K7
seeded from the camera, K12 at every
radius and both sigma_n forms, on the odd frame and through
``apply_filter``, K10 at every radius and depth, K11 at every radius,
sigma and depth, both on the odd frame and through ``apply_filter``;
and the wide forms held to this tree's twins: K5/K6 past max_motion 59,
K5c/K6c on a quarter tile's canvas, K10, K11 and K12 past radius 16),
and that the outputs are finite and of the expected
shapes.  No timing, no other
tree.
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
        M = kernel_ab.march_inputs(dev, kernel_ab.Tree(kernel_ab.PACKAGE))
        T = kernel_ab.temporal_inputs(dev)
    yield kernel_ab.planes(H, W, dev, 0), U, cots, S, M, T
    torch.set_num_threads(threads)
    kernel_ab.FRAME = frame


# (name pattern, expected number of cases, output shapes of the first)
FAMILIES = {
    "K14": (r"^K14 ", 20, [(3, *FRAME), FRAME]),
    "K14 tile": (r"^tile K14 ", 4, [(3, 28, 44), (28, 44)]),
    "K8": (r"^K8 ", 15, [(3, *FRAME), FRAME, (2, *FRAME)]),
    "K7": (r"^K7 ", 18, [FRAME, FRAME, FRAME, (3, *FRAME)]),
    "K2": (r"^K2b? r", 40, [(3, *FRAME), FRAME]),
    "K2 tile": (r"^tile K2b? ", 4, [(3, 28, 44), (28, 44)]),
    "KG": (r"^KG ", 13, [(10, *FRAME)]),
    "KGb": (r"^KGb ", 36, [(10, *FRAME), (2, *FRAME)]),
    "K13": (r"^K13 ", 6, [FRAME]),
    "K3": (r"^K3 ", 11, [(3, *FRAME), FRAME, (2, *FRAME), FRAME]),
    "K3b": (r"^K3b ", 4, [(3, *FRAME), FRAME, (2, *FRAME), FRAME]),
    "K15": (r"^K15 ", 12, [(6, 10), (), ()]),
    "K12": (r"^K12 r\d+ sigma", 14, [(3, *FRAME)]),
    "K12 odd": (r"^K12 .*odd", 2, [(3, FRAME[0] - 1, FRAME[1] - 3)]),
    "K12 apply_filter": (r"^K12 apply", 1, [(3, *FRAME)]),
    # K10 at r 0-4, 8, 16 (depth 1) and four deeper calls; K11 at five
    # radii, three sigmas, depth 1 and 2
    "K10": (r"^K10 r\d+ d\d+$", 11, [(3, *FRAME)]),
    "K10 odd": (r"^K10 .*odd", 2, [(3, FRAME[0] - 1, FRAME[1] - 3)]),
    "K10 apply_filter": (r"^K10 apply", 1, [(3, *FRAME)]),
    "K11": (r"^K11 r\d+ sigma \S+ d\d$", 30, [(3, *FRAME)]),
    "K11 odd": (r"^K11 .*odd", 2, [(3, FRAME[0] - 1, FRAME[1] - 3)]),
    "K11 apply_filter": (r"^K11 apply", 1, [(3, *FRAME)]),
    "K4": (r"^K4 ", 4, [(10, *FRAME)]),
    "K5": (r"^K5 ", 4, [(10, *FRAME), (2, *FRAME)]),
    "K6": (r"^K6 ", 4, [(10, *FRAME), (2, *FRAME)]),
    # quarter tiles of a frame of twice the sides; the adjoints' history
    # gradient covers the canvas (margin max_motion + 1 = 7)
    "K4c": (r"^K4c ", 8, [(10, *FRAME)]),
    "K5c": (r"^K5c ", 8, [(10, FRAME[0] + 14, FRAME[1] + 14), (2, *FRAME)]),
    "K6c": (r"^K6c ", 8, [(10, FRAME[0] + 14, FRAME[1] + 14), (2, *FRAME)]),
    # the wide forms, held to this tree's twin: max_motion 60 and 96 (the
    # canvas of the lower right quarter tile, margin 61 at M 60), radius
    # 17, 24 and 90 (K12: 17 and 24)
    "K5w": (r"^K5w ", 4, [(10, *FRAME), (2, *FRAME)]),
    "K6w": (r"^K6w ", 4, [(10, *FRAME), (2, *FRAME)]),
    "K5cw": (r"^K5cw ", 2, [(10, FRAME[0] // 2 + 122, FRAME[1] // 2 + 122),
                            (2, FRAME[0] // 2, FRAME[1] // 2)]),
    "K6cw": (r"^K6cw ", 2, [(10, FRAME[0] // 2 + 122, FRAME[1] // 2 + 122),
                            (2, FRAME[0] // 2, FRAME[1] // 2)]),
    "K10w": (r"^K10w ", 3, [(3, *FRAME)]),
    "K11w": (r"^K11w ", 3, [(3, *FRAME)]),
    "K12w": (r"^K12w ", 2, [(3, *FRAME)]),
}
# the outputs held bit for bit (True) or within rounding (False): KGb's
# and K5/K6's history gradients within rounding, every other output exact
EXACT = {"KGb": (False, True), "KGb history only": (False,),
         "KGb motion only": (True,), "K5": (False, True),
         "K6": (False, True), "K5c": (False, True), "K6c": (False, True)}


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
            form = next((f"{family} {only}" for only in ("history only",
                                                         "motion only")
                         if only in name), family)
            if isinstance(exact, kernel_ab.Twin):
                # the kernel's twin on the same inputs (here both are the
                # plain path)
                assert family.endswith("w"), name
                assert exact.close(out, exact.launch(this)()), name
            else:
                assert exact == EXACT.get(form, True), name
            assert all(bool(torch.isfinite(x.float()).all()) for x in out), \
                name
            if k == 0:
                assert [tuple(x.shape) for x in out] == shapes, name
