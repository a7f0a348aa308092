"""The registry tree, trimmed to what the port builds so far.

Mirrors ``vector_quantization_tpu/registries.py``: the same root and child
names, so a config's ``type`` resolves to the port's class of that name.
"""

from .utils.registry import Registry

VQRegistry = Registry("VQ")

DatasetRegistry = VQRegistry.child("datasets")
ModelRegistry = VQRegistry.child("models")
RunnerRegistry = VQRegistry.child("runners")
AlgorithmRegistry = VQRegistry.child("algorithms")
EncoderRegistry = ModelRegistry.child("encoders")
DecoderRegistry = ModelRegistry.child("decoders")
QuantizerRegistry = ModelRegistry.child("quantizers")
ConnectorRegistry = ModelRegistry.child("connectors")
DiscriminatorRegistry = ModelRegistry.child("discriminators")
TransformerRegistry = ModelRegistry.child("transformers")
TeacherRegistry = ModelRegistry.child("teachers")

CallbackRegistry = RunnerRegistry.child("callbacks")
MetricRegistry = RunnerRegistry.child("metrics")
StrategyRegistry = RunnerRegistry.child("strategies")
