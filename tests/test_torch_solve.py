"""The port's host solve path against the reference's, on the CPU: a
tiny-config anythingv3 registered model (the reference's own init,
carried across by the bridge) solves tasks hydrated by the port's
template engine. Checks: the same PNG bytes and CIDs as
arbius_tpu.node.solver.solve_cid_batch on the same uint8 images; a task's
CID does not depend on its chunk neighbours (canonical padding); CIDs are
stable from run to run."""
from __future__ import annotations

import jax
import numpy as np
import pytest

from arbius_tpu.codecs import encode_png as ref_encode_png
from arbius_tpu.models.sd15 import SD15Config as JConfig
from arbius_tpu.models.sd15 import SD15Pipeline as JPipeline
from arbius_tpu.node import solver as ref_solver
from arbius_tpu.templates import load_template as ref_load_template
from arbius_tpu_torch.l0 import generate_commitment, taskid2seed
from arbius_tpu_torch.models.sd15 import params_from_jax
from arbius_tpu_torch.node import (
    build_anythingv3,
    chunk_items,
    solve_cid_batch,
)
from arbius_tpu_torch.templates import hydrate_input

CANONICAL = 2


@pytest.fixture(scope="module")
def model():
    tree = jax.tree_util.tree_map(
        np.asarray, JPipeline(JConfig.tiny()).init_params(seed=0))
    return build_anythingv3(tiny=True, device="cpu",
                            params=params_from_jax(tree))


@pytest.fixture(scope="module")
def items(model):
    out = []
    for i in range(3):
        raw = {"prompt": f"a lighthouse, study {i}", "negative_prompt": "",
               "width": 128, "height": 128, "num_inference_steps": 2,
               "guidance_scale": 5.0 + i}
        taskid = "0x" + f"{i + 1:x}".rjust(64, "c")
        out.append((hydrate_input(raw, model.template), taskid2seed(taskid)))
    return out


@pytest.fixture(scope="module")
def solved(model, items):
    return solve_cid_batch(model, items, canonical_batch=CANONICAL)


def test_cids_and_pngs_equal_reference_path(model, items, solved):
    """The reference's solve path, fed the port's uint8 images, gives the
    same PNG bytes and CIDs."""
    pipe = model.runner.pipeline
    first = items[0][0]
    images = {}
    for chunk, _ in chunk_items(items, CANONICAL):
        out = pipe.generate(
            [h["prompt"] for h, _ in chunk],
            [h["negative_prompt"] for h, _ in chunk],
            [s for _, s in chunk], width=first["width"],
            height=first["height"],
            num_inference_steps=first["num_inference_steps"],
            guidance_scale=[h["guidance_scale"] for h, _ in chunk],
            scheduler=first["scheduler"])
        images.update((s, img) for (_, s), img in zip(chunk, out))

    class Replay:
        def run_batch(self, batch):
            return [{"out-1.png": ref_encode_png(images[s])}
                    for _, s in batch]

    ref_model = ref_solver.RegisteredModel(
        id=model.id, template=ref_load_template("anythingv3"),
        runner=Replay())
    want = ref_solver.solve_cid_batch(ref_model, items,
                                      canonical_batch=CANONICAL)
    assert [c for c, _ in solved] == [c for c, _ in want]
    assert [f for _, f in solved] == [f for _, f in want]
    for cid, _ in solved:
        assert cid.startswith("0x1220") and len(cid) == 70
        assert len(generate_commitment("0x" + "5a" * 20,
                                       "0x" + "01" * 32, cid)) == 32


def test_cid_independent_of_chunk_neighbours(model, items, solved):
    # item 2 ran padded with itself; here it shares a chunk with item 0
    again = solve_cid_batch(model, [items[2], items[0]],
                            canonical_batch=CANONICAL)
    assert again[0][0] == solved[2][0]
    assert again[1][0] == solved[0][0]


def test_cids_stable_across_runs(model, items, solved):
    assert solve_cid_batch(model, items, canonical_batch=CANONICAL) == solved


def test_runner_cache_tag(model, items):
    assert model.runner.cache_tag(items[0][0], 4) == \
        "sd15.4.128.128.2.DPMSolverMultistep"
