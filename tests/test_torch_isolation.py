"""The port stands alone: importing `deeplearning4j_tpu_torch`, serving
from it and training with it (fit through the flash-attention route, a
checkpoint written and restored) loads neither `jax` nor any module of
`deeplearning4j_tpu`, and
its entry points run on the card by default, raising where there is
none rather than carrying on quietly on the CPU."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models.transformer import (
    generate,
    gpt_configuration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import DecodeEngine
from deeplearning4j_tpu_torch.util.serialization import (
    restore_multi_layer_network,
)

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import deeplearning4j_tpu_torch
    from deeplearning4j_tpu_torch.models.transformer import (
        generate, gpt_configuration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import DecodeEngine
    from deeplearning4j_tpu_torch.util import serialization  # noqa: F401

    net = MultiLayerNetwork(gpt_configuration(16, d_model=16, n_heads=2,
                                              n_layers=1, max_length=32),
                            device="cpu")
    net.init()
    prompt = np.arange(5) % 16
    eng = DecodeEngine(net, n_slots=1, max_len=24, prompt_buckets=(8,),
                       prefill_chunk=8, page_size=8, device="cpu")
    try:
        got = eng.generate(np.arange(12) % 16, 3)
    finally:
        eng.shutdown()
    want = generate(net, (np.arange(12) % 16)[None], 3, temperature=0.0,
                    device="cpu")[0]
    assert (got == want).all(), (got, want)

    import os
    import tempfile
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.util.serialization import (
        restore_multi_layer_network, write_model)

    tnet = MultiLayerNetwork(gpt_configuration(16, d_model=128, n_heads=1,
                                               n_layers=1, max_length=256,
                                               attention_block_size=128),
                             device="cpu")
    ids = np.arange(2 * 257).reshape(2, 257) % 16
    data = DataSet(ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32))
    tnet.fit(ListDataSetIterator([data]), epochs=2)
    assert tnet.iteration == 2 and np.isfinite(tnet.score_value)
    assert fa.flash_attention_plain_bwd.calls == 2
    with tempfile.TemporaryDirectory() as d:
        write_model(tnet, os.path.join(d, "m.zip"))
        back = restore_multi_layer_network(os.path.join(d, "m.zip"),
                                           device="cpu")
    assert back.iteration == 2
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "deeplearning4j_tpu"
                    or m.startswith("deeplearning4j_tpu."))
    print("LEAKED", leaked)
    sys.exit(1 if leaked else 0)
""")


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=str(REPO),
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout


def test_no_port_source_names_jax():
    """No module of the port, and neither of its card scripts, imports
    jax or the JAX package."""
    bad = []
    for path in [*(REPO / "deeplearning4j_tpu_torch").rglob("*.py"),
                 REPO / "chip_smoke.py", REPO / "chip_fault_check.py"]:
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")) and (
                    s.split()[1].split(".")[0] in ("jax", "deeplearning4j_tpu")):
                bad.append(f"{path.name}: {s}")
    assert not bad, bad


def _tiny_net(device):
    conf = gpt_configuration(16, d_model=16, n_heads=2, n_layers=1,
                             max_length=32)
    return MultiLayerNetwork(conf, device=device)


def test_entry_points_default_to_the_card():
    """Without `device`, each entry point asks for CUDA: on a machine
    without a card it raises; with one it runs there."""
    cpu_net = _tiny_net("cpu")
    cpu_net.init()
    if torch.cuda.is_available():
        assert MultiLayerNetwork(cpu_net.conf).device.type == "cuda"
        with pytest.raises(ValueError, match="lives on"):
            DecodeEngine(cpu_net)
        with pytest.raises(ValueError, match="lives on"):
            generate(cpu_net, np.zeros((1, 3), np.int32), 2)
        return
    conf = cpu_net.conf
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiLayerNetwork(conf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(cpu_net)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(cpu_net, np.zeros((1, 3), np.int32), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore_multi_layer_network(REPO / "no-such.zip")
