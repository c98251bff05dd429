"""CNN serving demo on the PyTorch/CUDA port: compile a topology once,
stand up the serving Engine, and stream inference requests through it —
single-device (micro-batch queue), fault-tolerant (deadline SLOs through
the background flusher, admission control, injected faults healed by
retry or one-rung demotion), multi-tenant (two plans behind one Router:
a faulted tenant trips its circuit breaker while the other's answers
hold, then a verified hot swap and a rollback), and spatially pipelined
on a (stage, data) mesh of stream slots (the Engine's mesh rung).

The counterpart of ``examples/serve_cnn.py``, with the same flags and
``--device`` (the card unless ``cpu``). The reference's mesh needs one
host device per slot; the port's slots are streams of one device, so the
mesh section always runs.

    PYTHONPATH=src python examples/torch/serve_cnn.py
    PYTHONPATH=src python examples/torch/serve_cnn.py --topology cifar10_full \\
        --bits 6 --requests 32
"""
import argparse

import numpy as np
import torch

from repro_torch.core.dhm import Engine, QuantSpec, Router, compile_dhm
from repro_torch.core.dhm.faults import DispatchError, FaultPlan, NaNActivation
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.cnn import ALL_TOPOLOGIES, init_cnn

RTOL = ATOL = 1e-4  # the reference example's logits tolerance


def _close(got, want) -> None:
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=RTOL, atol=ATOL)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--topology", default="cifar10", choices=sorted(ALL_TOPOLOGIES))
    ap.add_argument("--bits", type=int, default=0,
                    help="fixed-point bits for weights + feature stream (0 = fp32)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--microbatch", type=int, default=8)
    ap.add_argument("--stages", type=int, default=0,
                    help="pipeline stages for the mesh engine "
                         "(0 = one per conv layer, capped at 3)")
    ap.add_argument("--device", default="cuda", help="the card (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    topo = ALL_TOPOLOGIES[args.topology]
    quant = QuantSpec(weight_bits=args.bits, act_bits=args.bits) if args.bits else QuantSpec()
    params = init_cnn(torch.Generator().manual_seed(0), topo, device=dev)
    rng = np.random.default_rng(0)
    h, w = topo.input_shape

    def random_request(i):
        n = int(rng.integers(1, args.microbatch + 1))
        return rng.normal(size=(n, h, w, topo.input_channels)).astype(np.float32)

    print(f"== single-device engine: {topo.name}, "
          f"{'fp32' if not args.bits else f'{args.bits}-bit'} plan on {dev.type} ==")
    plan = compile_dhm(topo, params, quant=quant, device=dev)
    eng = Engine(plan, microbatch=args.microbatch)
    reqs = [eng.submit(random_request(i)) for i in range(args.requests)]
    eng.flush()
    total = sum(r.result().shape[0] for r in reqs)
    x0 = random_request(0)
    _close(eng.infer(x0), plan(x0))
    print(f"  served {len(reqs)} requests / {total} frames, logits match "
          f"the plan; {eng.stats().summary()}")

    print("\n== SLO serving: background flusher, 25 ms deadlines, shed-oldest admission ==")
    with Engine(
        plan, microbatch=args.microbatch, auto_flush=True,
        max_queue=2 * args.requests, admission="shed_oldest",
        default_deadline_ms=25.0,
    ) as slo_eng:
        slo_reqs = [slo_eng.submit(random_request(i)) for i in range(args.requests)]
        done, missed = [], []
        for r in slo_reqs:
            try:
                r.result(timeout=30.0)
                done.append(r)
            except Exception as e:  # DeadlineExceeded / Shed: structured
                missed.append(f"{type(e).__name__}: {e}")
    print(f"  {len(done)}/{len(slo_reqs)} requests met their SLO; {slo_eng.stats().summary()}")
    for msg in missed[:3]:
        print(f"  missed: {msg}")

    print("\n== chaos: injected dispatch errors + NaN activations ==")
    chaos_eng = Engine(
        plan, microbatch=args.microbatch,
        fault_plan=FaultPlan([
            DispatchError(at=0, times=2),  # transient: retry heals
            NaNActivation(at=3, times=1),  # corrupted logits: caught
        ]),
        retry_backoff_s=1e-3,
    )
    for i in range(4):
        xi = random_request(i)
        _close(chaos_eng.infer(xi), plan(xi))
    st = chaos_eng.stats()
    print(f"  survived {st.n_retries} injected failures by retry "
          f"(rung: {st.rung}, demotions: {st.n_demotions}); logits verified "
          f"against the plan; {st.summary()}")

    print("\n== chaos: persistent fused-rung failure -> demotion ladder ==")
    demoted_eng = Engine(
        plan, microbatch=args.microbatch,
        fault_plan=FaultPlan([DispatchError(at=0, times=None, rung="fused")]),
        max_retries=1, retry_backoff_s=1e-3,
    )
    _close(demoted_eng.infer(x0), plan(x0))
    for d in demoted_eng.demotions:
        print(f"  demoted off rung {d['rung']!r}: {d['reason']}")
    if demoted_eng.rung != "per_layer":
        raise SystemExit(f"expected a demotion to per_layer, serving on {demoted_eng.rung!r}")
    print(f"  now serving on rung {demoted_eng.rung!r}, logits still match the healthy plan")

    print("\n== multi-tenant router: two plans, bulkheads, circuit breaker, hot swap ==")
    lenet = ALL_TOPOLOGIES["lenet5"]
    cifar = ALL_TOPOLOGIES["cifar10"]

    def compiled(t, seed):
        return compile_dhm(t, init_cnn(torch.Generator().manual_seed(seed), t, device=dev),
                           device=dev)

    plan_mnist, plan_cifar = compiled(lenet, 0), compiled(cifar, 0)

    def tenant_frames(t, n, seed):
        th, tw = t.input_shape
        return np.random.default_rng(seed).normal(
            size=(n, th, tw, t.input_channels)).astype(np.float32)

    # Every dispatch of tenant 'mnist' is faulted; 'cifar' is untouched.
    router = Router(
        fault_plan=FaultPlan([DispatchError(at=0, times=None, tenant="mnist")]),
        max_retries=0, allow_degraded=False,
        breaker_threshold=3, breaker_reset_s=60.0,
        microbatch=args.microbatch,
    )
    router.add("mnist", plan_mnist)
    router.add("cifar", plan_cifar)
    with router:
        mnist_errors = 0
        for i in range(6):
            try:
                router.submit("mnist", tenant_frames(lenet, 2, 10 + i)).result(timeout=30.0)
            except Exception:  # BatchFailed, then CircuitOpen: structured
                mnist_errors += 1
            xc = tenant_frames(cifar, 2, 20 + i)
            _close(router.infer("cifar", xc), plan_cifar(xc))
        st_cifar = router.engine("cifar").stats()
        print(f"  tenant 'mnist': {mnist_errors}/6 failed, breaker "
              f"{router.breaker('mnist').state!r} (fails fast, no dispatches wasted)")
        print(f"  tenant 'cifar': {st_cifar.n_ok} ok / {st_cifar.n_errors} errors — "
              "the bulkhead held")

        # Verified hot swap: retrained cifar weights go live with zero
        # dropped requests; a plan that fails verify_plan is refused.
        plan_cifar_v2 = compiled(cifar, 7)
        pre_swap = router.submit("cifar", tenant_frames(cifar, 2, 40))
        router.swap("cifar", plan_cifar_v2)
        _close(pre_swap.result(timeout=30.0), plan_cifar(tenant_frames(cifar, 2, 40)))
        x_post = tenant_frames(cifar, 2, 41)
        _close(router.infer("cifar", x_post), plan_cifar_v2(x_post))
        print("  hot swap 'cifar' -> v2: in-flight request answered by "
              "the OLD plan, next by the NEW — zero drops")
        try:
            router.swap("cifar", plan_mnist)  # wrong serving surface
        except Exception as e:
            print(f"  swap to incompatible plan refused: {type(e).__name__} "
                  "(old plan still serving)")
        else:
            raise SystemExit("a swap to a lenet5 plan was accepted")
        router.rollback("cifar")
        _close(router.infer("cifar", x_post), plan_cifar(x_post))
        print("  rollback 'cifar': v1 weights answering again")

    n_stages = args.stages or min(3, len(topo.conv_layers))
    data = 2
    print(f"\n== pipelined engine: ({n_stages} stage x {data} data) mesh of stream slots "
          f"on {dev.type} ==")
    plan_s = compile_dhm(topo, params, quant=quant, n_stages=n_stages, device=dev)
    for st in plan_s.stages:
        print(f"  stage {st.index}: {st.io.in_shape} -> {st.io.out_shape} "
              f"({st.cost_flops / 1e6:.2f} Mflop)")
    mesh = make_mesh((n_stages, data), ("stage", "data"), device=dev.type)
    engp = Engine(plan_s, microbatch=args.microbatch, mesh=mesh, n_microbatches=4,
                  data_axis="data")
    reqs = [engp.submit(random_request(i)) for i in range(args.requests)]
    engp.flush()
    total = sum(r.result().shape[0] for r in reqs)
    _close(engp.infer(x0), plan_s(x0))
    if engp.rung != "mesh":
        raise SystemExit(f"the pipelined engine left the mesh rung for {engp.rung!r}")
    print(f"  served {len(reqs)} requests / {total} frames through the "
          f"spatial pipeline, logits match the single-device plan; "
          f"{engp.stats().summary()}")
    print("OK")


if __name__ == "__main__":
    main()
