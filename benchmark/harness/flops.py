"""The calls one training iteration makes, from the shapes, layer by layer;
a phase file (``benchmark/phases/*.py``, ``calls``) strings them into its
iteration.

A network is a list of layers (from a family file's ``layers``): dicts
with ``kind`` (``conv`` or ``dense``), ``name``, ``cin``/``cout`` or
``fin``/``fout``, and for convs ``L`` (input length before padding),
``K``, ``stride`` and ``padding``; ``first`` marks a layer that reads the
network's input. A backward pass computes each layer's weight gradient
where the parameters train and its input gradient where one is needed:
never for a first layer whose input is data.
"""

from .costs import conv_cost, dense_cost


def forward(net, B: int) -> list:
    return [{**layer, "call": "fwd", "B": B} for layer in net]


def backward(net, B: int, params: bool = True, input_grad: bool = False) -> list:
    """``params``: weight gradients; ``input_grad``: the network's input
    needs a gradient (a first layer then computes its dx too)."""
    out = []
    for layer in net:
        if params:
            out.append({**layer, "call": "dw", "B": B})
        if input_grad or not layer.get("first"):
            out.append({**layer, "call": "dx", "B": B})
    return out


def cost(call) -> tuple:
    """(flops, bytes) of one call."""
    if call["kind"] == "conv":
        return conv_cost(call["call"], call["B"], call["L"], call["cin"], call["cout"],
                         call["stride"], call["K"], call["padding"])
    return dense_cost(call["call"], call["B"], call["fin"], call["fout"])


def step_flops(calls) -> float:
    return sum(cost(c)[0] for c in calls)
