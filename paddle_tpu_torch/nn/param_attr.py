"""`ParamAttr`: the port of `paddle_tpu/nn/param_attr.py`.
`initializer.create_parameter(..., attr=)` is the rule by which a layer
reads one.

A layer's `weight_attr` / `bias_attr` is None (the layer's default
initializer), a `ParamAttr`, an initializer (the port's
`nn.initializer` objects, called as `init(tensor, generator)`), a
string (the parameter's name) or, for a bias, False (no bias). An
attribute's `initializer` replaces the default draw and
`trainable=False` gives a parameter that does not require grad. The
other fields (`learning_rate`, `regularizer`, `do_model_average`,
`need_clip`) are kept on the attribute and read by nothing of the port
yet, as in the JAX package's layers."""
from __future__ import annotations

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        return ParamAttr(initializer=arg)

