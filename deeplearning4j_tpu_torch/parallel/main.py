"""ParallelWrapper CLI entry point (counterpart of
`deeplearning4j_tpu/parallel/main.py`).

Reference: `deeplearning4j-scaleout-parallelwrapper/.../parallelism/main/
ParallelWrapperMain.java` — JCommander flags `--modelPath
--dataSetIteratorFactoryClazz --workers --avgFrequency --uiUrl`, loads a
serialized model, builds the iterator via a factory class, trains, saves.

Usage:
    python -m deeplearning4j_tpu_torch.parallel.main \
        --model-path model.zip --data-factory mypkg.mymod:make_iterator \
        --epochs 2 --output-path trained.zip [--mode wrapper|averaging|ps] \
        [--device cuda|cpu]

The model is restored onto `--device` (the card by default; asking for
it without one raises) and trained there.
"""
from __future__ import annotations

import argparse
import importlib
import logging
import sys


def _load_factory(spec: str):
    """'package.module:callable' → iterator factory (reference
    `dataSetIteratorFactoryClazz`)."""
    mod_name, _, fn_name = spec.partition(":")
    if not fn_name:
        raise ValueError(
            f"--data-factory must be 'module:callable', got {spec!r}")
    mod = importlib.import_module(mod_name)
    return getattr(mod, fn_name)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch.parallel.main",
        description="Data-parallel training entry point (ParallelWrapperMain)")
    p.add_argument("--model-path", required=True,
                   help="serialized model zip (ModelSerializer format)")
    p.add_argument("--data-factory", required=True,
                   help="'module:callable' returning a DataSetIterator")
    p.add_argument("--output-path", required=True,
                   help="where to write the trained model zip")
    p.add_argument("--mode", choices=("wrapper", "averaging", "ps"),
                   default="wrapper",
                   help="wrapper = ParallelWrapper's step (default); "
                        "averaging = TrainingMaster parameter averaging; "
                        "ps = async parameter server")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--workers", type=int, default=2,
                   help="worker count for averaging/ps modes")
    p.add_argument("--avg-frequency", type=int, default=5,
                   help="averaging window (averaging/ps sync frequency)")
    p.add_argument("--ui-url", default=None,
                   help="remote UI endpoint for stats routing (host:port)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device the model trains on (default: the card)")
    return p


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from deeplearning4j_tpu_torch.util.serialization import (
        restore_model,
        write_model,
    )

    net = restore_model(args.model_path, device=args.device)
    iterator = _load_factory(args.data_factory)()

    router = None
    if args.ui_url:
        from deeplearning4j_tpu_torch.ui.remote import (
            RemoteUIStatsStorageRouter,
        )
        from deeplearning4j_tpu_torch.ui.stats_listener import StatsListener
        router = RemoteUIStatsStorageRouter(f"http://{args.ui_url}")
        net.set_listeners(*(net.listeners + [StatsListener(router)]))

    if args.mode == "wrapper":
        from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
        from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
        ParallelWrapper(net, mesh=make_mesh(devices=[net.device])).fit(
            iterator, epochs=args.epochs)
    elif args.mode == "averaging":
        from deeplearning4j_tpu_torch.parallel.training_master import (
            DistributedMultiLayer,
            ParameterAveragingTrainingMaster,
        )
        master = ParameterAveragingTrainingMaster(
            num_workers=args.workers,
            averaging_frequency=args.avg_frequency)
        DistributedMultiLayer(net, master).fit(iterator, epochs=args.epochs)
    else:
        from deeplearning4j_tpu_torch.parallel.parameter_server import (
            ParameterServerParallelWrapper,
        )
        ParameterServerParallelWrapper(
            net, workers=args.workers,
            sync_frequency=args.avg_frequency).fit(iterator,
                                                   epochs=args.epochs)

    if router is not None:
        router.shutdown()  # the router posts on its own thread: flush it
    write_model(net, args.output_path)
    logging.getLogger("deeplearning4j_tpu_torch").info(
        "trained model written to %s (final score %.5f)",
        args.output_path, net.score_value or float("nan"))
    return 0


if __name__ == "__main__":
    sys.exit(run())
