"""Augmentation policies: random choices that produce deterministic
Transforms (a copy of ``detectron2_tpu/data/transforms/augmentation.py``): an
:class:`Augmentation` inspects an :class:`AugInput` and returns a
:class:`Transform`; :class:`AugmentationList` chains them, updating the input
in place so later augmentations see earlier results.

Random draws come from an augmentation's ``rng``, a
``np.random.RandomState`` its owner sets (the train loader owns one and
hands it to the mapper's :class:`AugmentationList`). Without one they come
from numpy's global state, as in the JAX package and d2. A
``RandomState(s)`` draws what ``np.random.seed(s)`` and then the module's
functions draw, so the two packages can be held to the same sequence.
"""

import inspect
from typing import Any, List, Optional, Tuple, Union

import numpy as np

from detectron2_tpu_torch.data.transforms.transform import Transform, TransformList

__all__ = ["Augmentation", "AugmentationList", "AugInput", "apply_augmentations", "apply_transform_gens"]


class Augmentation:
    """A policy that defines distributions of transforms. ``get_transform``
    must be deterministic given its random draw."""

    input_args: Optional[Tuple[str]] = None
    rng: Optional[np.random.RandomState] = None

    @property
    def _random(self):
        """Where this augmentation draws from: ``rng``, else numpy's global
        state."""
        return np.random if self.rng is None else self.rng

    def set_rng(self, rng: Optional[np.random.RandomState]) -> None:
        """Draw from ``rng`` from now on (and so do the augmentations this
        one wraps)."""
        self.rng = rng

    def _init(self, params=None):
        if params:
            for k, v in params.items():
                if k != "self" and not k.startswith("_"):
                    setattr(self, k, v)

    def get_transform(self, *args) -> Transform:
        raise NotImplementedError

    def _get_aug_input_args(self, aug_input) -> List[Any]:
        """Extract the arguments get_transform needs from the AugInput."""
        if self.input_args is None:
            prms = list(inspect.signature(self.get_transform).parameters.items())
            if len(prms) == 1 and prms[0][0] == "args":
                names = ("image",)
            else:
                names = []
                for name, prm in prms:
                    if prm.kind in (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD):
                        raise TypeError(
                            f"The default implementation of `{type(self)}.__call__` does not allow "
                            f"`{type(self)}.get_transform` to use variable-length arguments (*args, **kwargs)! "
                            "If arguments are unknown, reimplement `__call__` instead."
                        )
                    names.append(name)
            self.input_args = tuple(names)
        args = []
        for f in self.input_args:
            try:
                args.append(getattr(aug_input, f))
            except AttributeError as e:
                raise AttributeError(
                    f"{type(self)}.get_transform needs input attribute '{f}', "
                    f"but it is not an attribute of {type(aug_input)}!"
                ) from e
        return args

    def __call__(self, aug_input) -> Transform:
        """Augment the input in place and return the transform used."""
        args = self._get_aug_input_args(aug_input)
        tfm = self.get_transform(*args)
        assert isinstance(tfm, (Transform, TransformList)), (
            f"{type(self)}.get_transform must return an instance of Transform! Got {type(tfm)} instead."
        )
        aug_input.transform(tfm)
        return tfm

    def _rand_range(self, low=1.0, high=None, size=None):
        if high is None:
            low, high = 0, low
        if size is None:
            size = []
        return self._random.uniform(low, high, size)

    def __repr__(self):
        try:
            sig = inspect.signature(self.__init__)
            argstr = []
            for name, param in sig.parameters.items():
                if hasattr(self, name):
                    argstr.append(f"{name}={getattr(self, name)!r}")
            return f"{self.__class__.__name__}({', '.join(argstr)})"
        except (AttributeError, TypeError, ValueError):
            return super().__repr__()

    __str__ = __repr__


class _TransformToAug(Augmentation):
    def __init__(self, tfm: Transform):
        self.tfm = tfm

    def get_transform(self, *args):
        return self.tfm

    def __call__(self, aug_input):
        aug_input.transform(self.tfm)
        return self.tfm


def _transform_to_aug(tfm_or_aug):
    if isinstance(tfm_or_aug, Augmentation):
        return tfm_or_aug
    assert isinstance(tfm_or_aug, Transform), tfm_or_aug
    return _TransformToAug(tfm_or_aug)


class AugmentationList(Augmentation):
    """Apply a sequence of augmentations/transforms in order. Given ``rng``,
    every augmentation in it draws from that ``RandomState``."""

    def __init__(self, augs, rng: Optional[np.random.RandomState] = None):
        super().__init__()
        self.augs = [_transform_to_aug(x) for x in augs]
        if rng is not None:
            self.set_rng(rng)

    def set_rng(self, rng: Optional[np.random.RandomState]) -> None:
        super().set_rng(rng)
        for aug in self.augs:
            aug.set_rng(rng)

    def __call__(self, aug_input) -> TransformList:
        tfms = []
        for x in self.augs:
            tfms.append(x(aug_input))
        return TransformList(tfms)

    def __repr__(self):
        msgs = [str(x) for x in self.augs]
        return "AugmentationList[{}]".format(", ".join(msgs))

    __str__ = __repr__


class AugInput:
    """Input to augmentations: image + optional boxes + sem_seg, transformed
    together."""

    def __init__(
        self,
        image: np.ndarray,
        *,
        boxes: Optional[np.ndarray] = None,
        sem_seg: Optional[np.ndarray] = None,
    ):
        self.image = image
        self.boxes = boxes
        self.sem_seg = sem_seg

    def transform(self, tfm: Transform) -> None:
        self.image = tfm.apply_image(self.image)
        if self.boxes is not None:
            self.boxes = tfm.apply_box(self.boxes)
        if self.sem_seg is not None:
            self.sem_seg = tfm.apply_segmentation(self.sem_seg)

    def apply_augmentations(self, augmentations) -> TransformList:
        return AugmentationList(augmentations)(self)


def apply_augmentations(augmentations, inputs):
    """Use AugInput -> (transformed, TransformList)."""
    if isinstance(inputs, np.ndarray):
        image_only = True
        inputs = AugInput(inputs)
    else:
        image_only = False
    tfms = inputs.apply_augmentations(augmentations)
    return inputs.image if image_only else inputs, tfms


apply_transform_gens = apply_augmentations
