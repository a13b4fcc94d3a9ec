"""Avro data contracts (layer 0).

Wire-compatible re-declarations of the reference's eight schemas
(reference: photon-avro-schemas/src/main/avro/*.avsc). Field names, types
and order are the contract — a model or dataset written here reads back in
the reference and vice versa. Doc strings are dropped (they don't affect
the encoding).
"""

NS = "com.linkedin.photon.avro.generated"

FEATURE_AVRO = {
    "type": "record", "name": "FeatureAvro", "namespace": NS,
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}

NAME_TERM_VALUE_AVRO = {
    "type": "record", "name": "NameTermValueAvro", "namespace": NS,
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}

TRAINING_EXAMPLE_AVRO = {
    "type": "record", "name": "TrainingExampleAvro", "namespace": NS,
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": FEATURE_AVRO}},
        {"name": "metadataMap",
         "type": ["null", {"type": "map", "values": "string"}], "default": None},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "offset", "type": ["null", "double"], "default": None},
    ],
}

BAYESIAN_LINEAR_MODEL_AVRO = {
    "type": "record", "name": "BayesianLinearModelAvro", "namespace": NS,
    "fields": [
        {"name": "modelId", "type": "string"},
        {"name": "modelClass", "type": ["null", "string"], "default": None},
        {"name": "means", "type": {"type": "array", "items": NAME_TERM_VALUE_AVRO}},
        {"name": "variances",
         "type": ["null", {"type": "array", "items": "NameTermValueAvro"}],
         "default": None},
        {"name": "lossFunction", "type": ["null", "string"], "default": None},
    ],
}

SCORING_RESULT_AVRO = {
    "type": "record", "name": "ScoringResultAvro", "namespace": NS,
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": ["null", "double"], "default": None},
        {"name": "modelId", "type": "string"},
        {"name": "predictionScore", "type": "double"},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "metadataMap",
         "type": ["null", {"type": "map", "values": "string"}], "default": None},
    ],
}

RESPONSE_PREDICTION_AVRO = {
    "type": "record", "name": "SimplifiedResponsePrediction", "namespace": NS,
    "fields": [
        {"name": "response", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": FEATURE_AVRO}},
        {"name": "weight", "type": "double", "default": 1.0},
        {"name": "offset", "type": "double", "default": 0.0},
    ],
}

LATENT_FACTOR_AVRO = {
    "type": "record", "name": "LatentFactorAvro", "namespace": NS,
    "fields": [
        {"name": "effectId", "type": "string"},
        {"name": "latentFactor", "type": {"type": "array", "items": "double"}},
    ],
}

FEATURE_SUMMARIZATION_RESULT_AVRO = {
    "type": "record", "name": "FeatureSummarizationResultAvro", "namespace": NS,
    "fields": [
        {"name": "featureName", "type": "string"},
        {"name": "featureTerm", "type": "string"},
        {"name": "metrics", "type": {"type": "map", "values": "double"}},
    ],
}
