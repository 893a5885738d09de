"""K4's inputs at the spacing's shapes, shared by the port's card tests and
``chip_smoke.py``, which import it by name.  Torch only: the card tests
import no JAX."""
import torch

#: the spacing's shapes in the benchmark's cells (P, rows a cloud, live
#: rows of each cloud): ``tls131k.batch8`` (8 clouds of 96000-131072 live
#: rows in 131072), ``resso60k.batch8`` (at most 60000 in 65536) and
#: ``resso60k.single``
BENCH_CLOUDS = (
    (8, 131072, (100000, 96000, 131072, 99000, 97000, 100000, 98000, 96500)),
    (8, 65536, (60000, 59000, 60000, 57000, 60000, 58000, 60000, 55000)),
    (1, 65536, (60000,)),
)


def spacing_inputs(P, N, live, samples=10000, seed=0):
    """P clouds of N rows on the card, cloud p's first ``live[p]`` rows
    points of a 4 m room-sized box (row 5 copied to rows 10-19), the rest
    BIG (1e8), with their mask, and the queries ``average_spacing`` draws
    from them: ``samples`` strided live rows a cloud."""
    from plade_tpu_torch.knn import bruteforce
    g = torch.Generator(device="cuda").manual_seed(seed)
    pts = torch.rand(P, N, 3, device="cuda", generator=g) * 4.0 - 2.0
    pts[:, 10:20] = pts[:, 5:6]
    mask = torch.arange(N, device="cuda") \
        < torch.tensor(live, device="cuda")[:, None]
    pts = torch.where(mask[..., None], pts, 1e8).contiguous()
    seen = []

    def recorded(queries, refs, k, *a):
        seen.append(queries)
        return queries.new_zeros(queries.shape[:-1] + (k,))
    bruteforce.average_spacing(pts, mask, 6, samples,
                               bruteforce.ONE_DEVICE._replace(
                                   topk_dist_sq=recorded))
    return pts, mask, seen[0]
