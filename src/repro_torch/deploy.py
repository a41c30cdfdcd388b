"""Deployment artifact: the persistable bundle behind one compiled BNN
(port of `repro/deploy.py`).

A :class:`Deployment` is folded layers + binary input encoding +
`EnsembleConfig` + `NoiseModel`/`AnalogParams` + compile options:

  * :func:`deploy` builds one from folded layers, or from trained
    parameters and their config (folded here), MLP and CNN alike;
  * `pipeline()` compiles `pipeline.compile_pipeline` lazily, on the card
    unless the deployment (or the call) names another device;
  * `save(dir)` writes `deployment.json` plus an atomic checkpoint step of
    bit-packed weights (`checkpoint/ckpt.py`); `Deployment.load(dir)`
    rebuilds a deployment whose `run(x, spec)` is bit-identical.

The on-disk format is the reference's, schema `picbnn-deployment/v1`, so
a directory saved by either package loads in the other::

    <dir>/deployment.json       layer topology, ensemble / noise /
                                encoding / compile options
    <dir>/step_00000000/        manifest.json + one .npy per leaf: packed
                                uint32 weight words and int32 C_j per layer

`compile_options` are the reference's `compile_pipeline` options, which
the two packages share on disk:

  * `min_bucket`, `max_bucket` — mapped: the port's bucket grid;
  * `impl`, `interpret`, `chunk`, `bq` — ignored: they choose among the
    reference's JAX implementations (the port has one route per spec,
    and its kernels size their own tiles);
  * `donate` — passed on to `compile_pipeline`, which accepts it and
    ignores it, as the reference's backends that cannot reuse the
    buffer do.

Any other option is rejected when the Deployment is built, so a
port-saved manifest carries only options the reference accepts.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import pipeline as _pipeline
from repro_torch.checkpoint import ckpt
from repro_torch.core import binarize, bnn, convnet
from repro_torch.core.binarize import InputEncoding
from repro_torch.core.bnn import FoldedLayer, MLPConfig
from repro_torch.core.convnet import CNNConfig, FoldedConvLayer, is_conv_layer
from repro_torch.core.device_model import AnalogParams, NoiseModel
from repro_torch.core.ensemble import EnsembleConfig
from repro_torch.spec import InferenceSpec

SCHEMA = "picbnn-deployment/v1"

#: compile_pipeline options a Deployment may carry (the reference's set)
COMPILE_OPTIONS = ("impl", "bq", "chunk", "min_bucket", "max_bucket",
                   "interpret", "donate")
#: the subset with a counterpart in the port, passed to compile_pipeline
MAPPED_OPTIONS = ("min_bucket", "max_bucket", "donate")


def _np_unpack_bits(words: np.ndarray, n_bits: int) -> np.ndarray:
    """NumPy twin of binarize.unpack_bits (little-endian uint32 words)."""
    shifts = np.arange(32, dtype=np.uint32)
    bits = (words[..., None] >> shifts) & np.uint32(1)
    return bits.reshape(*words.shape[:-1], -1)[..., :n_bits].astype(np.uint8)


def _pack_rows(weights_pm1: np.ndarray) -> np.ndarray:
    """±1 weight rows (any trailing shape) -> packed uint32 words."""
    w = np.asarray(weights_pm1)
    rows = w.reshape(w.shape[0], -1)
    return binarize.np_pack_bits((rows > 0).astype(np.uint8))


def _unpack_rows(words: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """Inverse of `_pack_rows`: packed words -> ±1 int8 of `shape`."""
    shape = tuple(int(s) for s in shape)
    n_bits = int(np.prod(shape[1:]))
    bits = _np_unpack_bits(np.asarray(words).view(np.uint32), n_bits)
    return (bits.astype(np.int8) * 2 - 1).reshape(shape)


@dataclasses.dataclass
class Deployment:
    """A persistable deployed BNN: model + physics + compile config.

    Construct with :func:`deploy` (or :meth:`load`); treat as immutable.
    `pipeline()` compiles lazily and caches per device; `run()` /
    `warmup()` delegate to it.  `device` (not saved) is where
    `pipeline()` compiles by default: None means the CUDA card.
    """

    folded: tuple  # FoldedConvLayer prefix + FoldedLayer tail
    ens_cfg: EnsembleConfig
    noise: Optional[NoiseModel] = None
    params: Optional[AnalogParams] = None
    image_side: Optional[int] = None
    image_encoding: Optional[InputEncoding] = None
    compile_options: dict = dataclasses.field(default_factory=dict)
    device: Optional[Union[str, torch.device]] = dataclasses.field(
        default=None, compare=False)
    _pipes: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    def __post_init__(self):
        unknown = set(self.compile_options) - set(COMPILE_OPTIONS)
        if unknown:
            raise ValueError(
                f"unknown compile options {sorted(unknown)}; "
                f"known: {COMPILE_OPTIONS}"
            )

    @property
    def conv_layers(self) -> tuple:
        """The FoldedConvLayer prefix (empty for MLP deployments)."""
        return tuple(l for l in self.folded if is_conv_layer(l))

    @property
    def layer_sizes(self) -> Optional[tuple[int, ...]]:
        """(n_in, ..., n_classes) for pure-MLP deployments, else None."""
        if self.conv_layers:
            return None
        return (int(self.folded[0].n_in),) + tuple(
            int(l.n_out) for l in self.folded)

    def pipeline(self, device=None) -> _pipeline.CompiledPipeline:
        """The compiled pipeline on `device` (default: the deployment's;
        None means the card), built on first call, then cached."""
        dev = _pipeline.resolve_device(
            self.device if device is None else device)
        pipe = self._pipes.get(dev)
        if pipe is None:
            kw = {k: v for k, v in self.compile_options.items()
                  if k in MAPPED_OPTIONS}
            if self.image_side is not None:
                kw["image_side"] = self.image_side
                kw["image_encoding"] = self.image_encoding
            pipe = _pipeline.compile_pipeline(
                list(self.folded), self.ens_cfg, device=dev,
                noise=self.noise, params=self.params, **kw
            )
            self._pipes[dev] = pipe
        return pipe

    def run(self, x, spec: InferenceSpec, *, key=None,
            keys=None) -> torch.Tensor:
        """`CompiledPipeline.run` on the (lazily compiled) pipeline."""
        return self.pipeline().run(x, spec, key=key, keys=keys)

    def warmup(self, max_batch: int, **kw):
        """`CompiledPipeline.warmup` on the (lazily compiled) pipeline."""
        return self.pipeline().warmup(max_batch, **kw)

    def save(self, root: Union[str, Path]) -> Path:
        """Persist to `root/`: packed-weight checkpoint, then
        `deployment.json` (its presence marks a complete artifact).
        Returns `root` as a Path."""
        root = Path(root)
        tree = {"layers": []}
        layers_meta = []
        for layer in self.folded:
            meta = {"kind": "conv" if is_conv_layer(layer) else "fc",
                    "shape": list(np.shape(layer.weights_pm1))}
            if is_conv_layer(layer):
                meta["stride"] = int(layer.stride)
            layers_meta.append(meta)
            tree["layers"].append({
                "w": _pack_rows(layer.weights_pm1),
                "c": np.asarray(layer.c, np.int32),
            })
        ckpt.save(root, step=0, tree=tree)
        manifest = {
            "schema": SCHEMA,
            "layers": layers_meta,
            "ens_cfg": {
                "thresholds": [int(t) for t in self.ens_cfg.thresholds],
                "bias_cells": int(self.ens_cfg.bias_cells),
                "mode": self.ens_cfg.mode,
                "calibrated": bool(self.ens_cfg.calibrated),
                "noise": dataclasses.asdict(self.ens_cfg.noise),
            },
            "noise": (None if self.noise is None
                      else dataclasses.asdict(self.noise)),
            "analog_params": (None if self.params is None
                              else dataclasses.asdict(self.params)),
            "image_side": self.image_side,
            "image_encoding": (None if self.image_encoding is None else {
                "kind": self.image_encoding.kind,
                "width": int(self.image_encoding.width),
            }),
            "compile_options": self.compile_options,
        }
        (root / "deployment.json").write_text(json.dumps(manifest, indent=1))
        return root

    @classmethod
    def load(cls, root: Union[str, Path], *, device=None) -> "Deployment":
        """Reconstruct a Deployment saved by :meth:`save` (by either
        package); `device` is where its pipeline compiles by default."""
        root = Path(root)
        mf_path = root / "deployment.json"
        if not mf_path.exists():
            raise FileNotFoundError(
                f"{root} is not a deployment directory (no deployment.json)"
            )
        mf = json.loads(mf_path.read_text())
        if mf.get("schema") != SCHEMA:
            raise ValueError(
                f"unsupported deployment schema {mf.get('schema')!r} "
                f"(expected {SCHEMA})"
            )
        template = {"layers": [
            {"w": np.empty((int(lm["shape"][0]), binarize.packed_width(
                int(np.prod(lm["shape"][1:])))), np.uint32),
             "c": np.empty((int(lm["shape"][0]),), np.int32)}
            for lm in mf["layers"]]}
        tree, _step = ckpt.restore(root, None, template)
        folded = []
        for lm, leaf in zip(mf["layers"], tree["layers"]):
            w = _unpack_rows(leaf["w"], lm["shape"])
            c = np.asarray(leaf["c"], np.int64)
            if lm["kind"] == "conv":
                folded.append(FoldedConvLayer(weights_pm1=w, c=c,
                                              stride=int(lm["stride"])))
            else:
                folded.append(FoldedLayer(weights_pm1=w, c=c))
        ecd = mf["ens_cfg"]
        enc = mf["image_encoding"]
        return cls(
            folded=tuple(folded),
            ens_cfg=EnsembleConfig(
                thresholds=tuple(ecd["thresholds"]),
                bias_cells=ecd["bias_cells"],
                mode=ecd["mode"],
                calibrated=ecd["calibrated"],
                noise=NoiseModel(**ecd["noise"]),
            ),
            noise=(None if mf["noise"] is None
                   else NoiseModel(**mf["noise"])),
            params=(None if mf["analog_params"] is None
                    else AnalogParams(**mf["analog_params"])),
            image_side=mf["image_side"],
            image_encoding=(None if enc is None
                            else InputEncoding(enc["kind"], enc["width"])),
            compile_options=dict(mf["compile_options"]),
            device=device,
        )


def is_deployment_dir(path: Union[str, Path]) -> bool:
    """True when `path` holds a saved Deployment (has deployment.json)."""
    return (Path(path) / "deployment.json").exists()


def deploy(model, *, config: Union[MLPConfig, CNNConfig, None] = None,
           ens_cfg: Optional[EnsembleConfig] = None,
           noise: Optional[NoiseModel] = None,
           params: Optional[AnalogParams] = None,
           image_side: Optional[int] = None,
           image_encoding: Optional[InputEncoding] = None,
           device=None, **compile_options) -> Deployment:
    """Build a `Deployment` from a model — MLP and CNN configs alike.

    model : folded layers (`bnn.fold` / `convnet.fold_cnn` /
        `convnet.random_folded_cnn` output), or trained parameters (numpy
        leaves, or `train_mlp`/`train_cnn`'s tensors on any device) —
        then `config` is required and the fold runs here.
    config : optional `MLPConfig` | `CNNConfig`: the bias cells of the
        default ensemble config and (CNN) the image side and encoding.
    ens_cfg / noise / params / image_side / image_encoding : as
        `pipeline.compile_pipeline`; explicit arguments win.
    device : where `pipeline()` compiles by default (None: the card).
    compile_options : one of `COMPILE_OPTIONS` (see the module doc).
    """
    if isinstance(model, dict):
        if isinstance(config, CNNConfig):
            folded = convnet.fold_cnn(model, config)
        elif isinstance(config, MLPConfig):
            folded = bnn.fold(model, config)
        else:
            raise ValueError(
                "deploy(params_dict) needs config=MLPConfig|CNNConfig "
                "to fold the trained parameters"
            )
    else:
        folded = list(model)
    if isinstance(config, CNNConfig):
        image_side = config.side if image_side is None else image_side
        image_encoding = (config.encoding if image_encoding is None
                          else image_encoding)
    if ens_cfg is None:
        bias = getattr(config, "bias_cells", None)
        ens_cfg = (EnsembleConfig(bias_cells=bias) if bias is not None
                   else EnsembleConfig())
    return Deployment(
        folded=tuple(folded),
        ens_cfg=ens_cfg,
        noise=noise,
        params=params,
        image_side=image_side,
        image_encoding=image_encoding,
        compile_options=compile_options,
        device=device,
    )
