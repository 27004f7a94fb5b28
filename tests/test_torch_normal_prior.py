"""The criterion's normal and its fused kernel's wrapper, on the CPU.

`QuadCriterion_MRS.normal_op` and `QuadCriterion_MRS_2D.normal_op` give
µ_s·HᵗH x + µ_r·DᵀD x bit for bit as the plain spelling, in float32 and
float64, with no launch of `core.normal_prior`'s kernel (it takes float32
CUDA tensors only, held on the card in tests/test_torch_kernels_cuda.py);
a float32 x on the card reaches the kernel as contiguous [B, H, W] planes
(a CPU tensor that says it is on the card, the kernel replaced by the
plain formula); the joint Fourier prior keeps its own route; `lcg` and
`mmmg` apply `normal_op` once a normal; `launch_rows` fits a block's strip
and window.
"""

import numpy as np
import pytest
import torch

from surfh_tpu_torch.core import normal_prior as fused
from surfh_tpu_torch.simulation.synthetic import make_model, make_setup
from surfh_tpu_torch.solvers.criterion import QuadCriterion_MRS, QuadCriterion_MRS_2D, dtd_separated

torch.set_num_threads(2)


class _Diag:
    """HᵗH x = d·x elementwise: a model the criterion takes, on the CPU."""

    def __init__(self, shape, dtype, seed=0):
        g = torch.Generator().manual_seed(seed)
        self.ishape, self.dtype, self.device = tuple(shape), dtype, torch.device("cpu")
        self.d = torch.rand(self.ishape, generator=g, dtype=dtype) + 0.5

    def forward(self, x):
        return (self.d.sqrt() * x.reshape(self.ishape)).reshape(-1)

    def adjoint(self, y):
        return self.d.sqrt() * y.reshape(self.ishape)

    def normal(self, x):
        return self.d * x


def _crit(cls, shape, dtype, gradient="separated"):
    model = _Diag(shape, dtype)
    kw = {} if cls is QuadCriterion_MRS_2D else {"gradient": gradient}
    return cls(3.7, torch.zeros(int(np.prod(shape)), dtype=dtype), model, 0.3, **kw), model


def _x(shape, dtype, seed=1):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed), dtype=dtype)


def _dtd_2d(x):
    return dtd_separated(x[None])[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cls, shape", [(QuadCriterion_MRS, (4, 13, 17)), (QuadCriterion_MRS, (3, 1, 2)),
                                        (QuadCriterion_MRS_2D, (13, 17)), (QuadCriterion_MRS_2D, (2, 3))])
def test_normal_op_is_the_plain_formula_bit_for_bit(cls, shape, dtype):
    crit, model = _crit(cls, shape, dtype)
    x = _x(shape, dtype)
    mu_s, mu_r = crit.mu_spectro, crit.mu_reg
    dtd = dtd_separated if cls is QuadCriterion_MRS else _dtd_2d
    before = fused.launches
    assert torch.equal(crit.normal_op(x, mu_s, mu_r), mu_s * model.normal(x) + mu_r * dtd(x))
    assert fused.launches == before


def test_normal_op_on_a_cube_model_is_the_plain_formula_bit_for_bit():
    """A W-plane model with the cube as its unknown (the voxel cell's shape
    of problem), float32: HᵗH from the model's own normal."""
    setup = dict(make_setup(im_size=31, n_lambda=16, n_tpl=3, n_channels=2, n_pointings=1, n_slit=3),
                 templates=None)
    model = make_model(setup=setup, dtype=np.float32, window_local=False)[0].to("cpu", torch.float32)
    crit = QuadCriterion_MRS(5e3, torch.zeros(model.oshape[0]), model, 0.25)
    x = torch.rand(model.ishape, generator=torch.Generator().manual_seed(2))
    want = crit.mu_spectro * model.normal(x) + crit.mu_reg * dtd_separated(x)
    assert torch.equal(crit.normal_op(x, crit.mu_spectro, crit.mu_reg), want)


class _CardLike(torch.Tensor):
    """A CPU tensor that says it is on the card: what `normal_op` routes."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def routed(monkeypatch):
    """The kernel replaced by the plain formula with a record of its
    operands' shapes and layouts: what `normal_op` would launch."""
    calls = []

    def kernel(x, h, mu_s, mu_r):
        calls.append((tuple(x.shape), tuple(h.shape), x.is_contiguous() and h.is_contiguous()))
        return mu_s * h + mu_r * dtd_separated(x)

    monkeypatch.setattr(fused, "normal_prior_cuda", kernel)
    return calls


@pytest.mark.parametrize("cls, shape, planes", [(QuadCriterion_MRS, (4, 13, 17), (4, 13, 17)),
                                                (QuadCriterion_MRS_2D, (13, 17), (1, 13, 17))])
def test_separated_prior_routes_its_planes_to_the_kernel(routed, cls, shape, planes):
    """A float32 x on the card goes to the kernel as [B, H, W] planes (the
    2-D image as one plane), contiguous even when x is strided; float64
    keeps the plain spelling."""
    crit, model = _crit(cls, shape, torch.float32)
    dtd = dtd_separated if cls is QuadCriterion_MRS else _dtd_2d
    x = _x(shape, torch.float32)
    for xin in (x, x.transpose(-1, -2).contiguous().transpose(-1, -2)):
        got = crit.normal_op(xin.as_subclass(_CardLike), crit.mu_spectro, crit.mu_reg)
        assert got.shape == x.shape
        assert torch.equal(got, crit.mu_spectro * model.normal(x) + crit.mu_reg * dtd(x))
    assert routed == [(planes, planes, True)] * 2
    crit64, _ = _crit(cls, shape, torch.float64)
    crit64.normal_op(_x(shape, torch.float64).as_subclass(_CardLike), crit64.mu_spectro, crit64.mu_reg)
    assert len(routed) == 2


def test_joint_prior_keeps_its_route(routed):
    crit, model = _crit(QuadCriterion_MRS, (3, 12, 10), torch.float32, gradient="joint")
    x = _x((3, 12, 10), torch.float32)
    got = crit.normal_op(x.as_subclass(_CardLike), crit.mu_spectro, crit.mu_reg)
    assert routed == []
    assert torch.equal(got, crit.mu_spectro * model.normal(x) + crit.mu_reg * crit._joint.DtD(x))


@pytest.mark.parametrize("method", ["lcg", "mmmg"])
def test_solvers_reach_the_kernel_once_a_normal(method):
    """`lcg` and `mmmg` apply `normal_op`, the kernel's one route, once a normal."""
    crit, _ = _crit(QuadCriterion_MRS, (2, 9, 11), torch.float32)
    crit.y_spectro = _x(2 * 9 * 11, torch.float32)
    shapes, normal_op = [], crit.normal_op

    def counted(x, mu_s, mu_r):
        shapes.append(tuple(x.shape))
        return normal_op(x, mu_s, mu_r)

    crit.normal_op = counted
    crit.run_method(method, maximum_iterations=3, tolerance=0.0)
    assert shapes == [(2, 9, 11)] * (1 + 3)  # the initial residual (gradient) and one a step


def test_takes_nothing_off_the_card():
    x = _x((2, 5, 6), torch.float32)
    mu = torch.tensor(1.0)
    with pytest.raises(ValueError):
        fused.normal_prior_cuda(x, x.clone(), mu, mu)


@pytest.mark.parametrize("h, w, rows", [(501, 501, 16), (37, 41, 37), (64, 512, 15), (20, 1024, 7),
                                        (10, 2048, 3), (1, 1, 1), (3, 2, 3), (2, 3972, 1),
                                        (2, 3973, 0), (0, 5, 0)])
def test_launch_rows_fit_the_strip_and_the_window(h, w, rows):
    assert fused.launch_rows(h, w) == rows
    if rows:
        n = (rows + 2) * w
        assert rows <= h and rows * w <= fused.STRIP_FLOATS and n + n // 32 <= fused.SMEM_FLOATS
        if rows < h:  # one row more would not fit
            n1 = (rows + 3) * w
            assert (rows + 1) * w > fused.STRIP_FLOATS or n1 + n1 // 32 > fused.SMEM_FLOATS
