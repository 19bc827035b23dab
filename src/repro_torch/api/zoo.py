"""The paper's benchmark CNNs — plus sequence models — as builder programs.

A copy of ``repro.api.zoo``: the graphs are layer-for-layer the JAX
package's, so both compile to equal programs.  The CNNs are the graphs
the paper §IV evaluates.

``vit_tiny`` opens the transformer workload class (DESIGN.md §9): a
patchify conv, ``depth`` post-norm encoder blocks (attention + MLP,
each ``x = LN(x + f(x))``), and a mean-pooled classifier head — every
block built from the sequence ops the crossbar program stack lowers
(attention expands into dynamic-operand GEMM stages).  The default is a
CI-scale reduction (2 blocks of the ViT-Tiny geometry: dim 192, 3
heads, MLP ratio 4); pass ``depth=12`` for the full-size model.
"""

from __future__ import annotations

from .graph import NetworkBuilder, NetworkGraph


def alexnet_graph() -> NetworkGraph:
    nb = NetworkBuilder("alexnet", input_hw=32, input_ch=3)
    for i, (ch, pool) in enumerate([(64, True), (192, True), (384, False),
                                    (256, False), (256, True)], 1):
        nb.conv(ch, name=f"conv{i}")
        nb.relu(name=f"relu{i}")
        if pool:
            nb.maxpool(name=f"pool{i}")
    # CIFAR-scale classifier (1024-unit FC variant commonly used for
    # AlexNet-CIFAR; the ImageNet 4096-unit head would dwarf the convs)
    nb.fc(1024, name="fc6")
    nb.relu(name="relu6")
    nb.fc(1024, name="fc7")
    nb.relu(name="relu7")
    nb.fc(10, name="fc8")
    nb.softmax(name="softmax")
    return nb.build()


def vgg16_graph() -> NetworkGraph:
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M"]
    nb = NetworkBuilder("vgg16", input_hw=32, input_ch=3)
    i = 1
    for v in cfg:
        if v == "M":
            nb.maxpool(name=f"pool{i}")
        else:
            nb.conv(v, name=f"conv{i}")
            nb.relu(name=f"relu{i}")
            i += 1
    nb.fc(512, name="fc1")
    nb.relu(name="relu_fc1")
    nb.fc(10, name="fc2")
    nb.softmax(name="softmax")
    return nb.build()


def resnet18_graph() -> NetworkGraph:
    nb = NetworkBuilder("resnet18", input_hw=32, input_ch=3)
    nb.conv(64, name="conv0")
    entry = nb.relu(name="relu0")     # block input = prev block's output
    in_ch = 64
    for stage, ch in enumerate((64, 128, 256, 512)):
        for b in range(2):
            s = 2 if (stage > 0 and b == 0) else 1
            n = f"s{stage}b{b}"
            res_src = entry           # identity shortcut unless projected
            if in_ch != ch:
                # 1x1 projection on the shortcut (its own GEMM group)
                res_src = nb.conv(ch, k=1, stride=s, padding=0,
                                  name=f"{n}_proj", input_from=entry)
            nb.conv(ch, stride=s, name=f"{n}_conv1", input_from=entry)
            nb.relu(name=f"{n}_relu1")
            nb.conv(ch, name=f"{n}_conv2")
            nb.residual(res_src, name=f"{n}_res")
            entry = nb.relu(name=f"{n}_relu2")
            in_ch = ch
    nb.avgpool(k=4, stride=4, name="avgpool")
    nb.fc(10, name="fc")
    nb.softmax(name="softmax")
    return nb.build()


def vit_tiny_graph(depth: int = 2, dim: int = 192, heads: int = 3,
                   mlp_ratio: int = 4, patch: int = 4, input_hw: int = 32,
                   input_ch: int = 3, classes: int = 10) -> NetworkGraph:
    """Patchify conv + ``depth`` post-norm encoder blocks + pooled head.

    CIFAR-scale ViT: a ``patch x patch`` stride-``patch`` conv rasterizes
    the image into ``(input_hw/patch)^2`` tokens of dim ``dim``; each
    encoder block is ``x = LN(x + MHA(x)); x = LN(x + MLP(x))``
    (post-norm, so both normalizations are FB post-ops of their
    residual's GEMM stage); the head mean-pools the tokens and
    classifies.  Attention lowers into the dynamic-operand GEMM stages
    of DESIGN.md §9.
    """
    nb = NetworkBuilder("vit_tiny", input_hw=input_hw, input_ch=input_ch)
    if input_hw % patch:
        raise ValueError(f"vit_tiny: patch {patch} does not tile "
                         f"{input_hw}x{input_hw}")
    entry = nb.conv(dim, k=patch, stride=patch, padding=0, name="patch")
    for i in range(depth):
        nb.attention(heads, name=f"b{i}_attn")
        nb.residual(entry, name=f"b{i}_res1")
        r1 = nb.layernorm(name=f"b{i}_ln1")
        nb.linear(dim * mlp_ratio, name=f"b{i}_fc1")
        nb.gelu(name=f"b{i}_gelu")
        nb.linear(dim, name=f"b{i}_fc2")
        nb.residual(r1, name=f"b{i}_res2")
        entry = nb.layernorm(name=f"b{i}_ln2")
    nb.seqpool(name="pool")
    nb.fc(classes, name="head")
    nb.softmax(name="softmax")
    return nb.build()


vit_tiny = vit_tiny_graph


GRAPHS = {
    "alexnet": alexnet_graph,
    "vgg16": vgg16_graph,
    "resnet18": resnet18_graph,
    "vit_tiny": vit_tiny_graph,
}
