"""Write the TensorFlow-free records that the card tests replay
(tests/torch_port_fixtures/tf_*.npz): each model is built with keras
(``KERAS_BACKEND=tensorflow``), traced with ``tf.function`` and recorded by
``horovod_tpu_torch.tensorflow.compile.record_function`` without its
weights (a record keeps each variable's fill value or standard deviation;
the replay draws the weights from a seed).

- ``tf_resnet50.npz``: BASELINE config #2 at full width,
  ``tf.keras.applications.ResNet50(weights=None)`` (224x224x3, 1000
  classes, as in examples/tensorflow2_synthetic_benchmark.py) with the
  classifier's softmax folded into the loss: ``(loss, logits) =
  f(images, labels)`` in training mode (batch statistics, moving-average
  writes).
- ``tf_encoder_causal.npz`` / ``tf_encoder.npz``: a keras encoder at
  BERT-large widths (hidden 1024, 16 heads of key_dim 64, FFN 4096, 24
  layers, vocab 30522) of ``keras.layers.MultiHeadAttention`` blocks,
  dropout 0, with and without ``use_causal_mask``: ``loss = f(ids,
  labels)``, sequence length free.
- ``tf_rank.npz``: ``f(x) = x * rank + size`` through the TF binding's
  rank and size ops, which the record keeps as queries.

Run here (it needs tensorflow; the card has none):

    KERAS_BACKEND=tensorflow python scripts/torch_port_tf_records.py \\
        [--out tests/torch_port_fixtures] [--only resnet50,encoder,rank]

``build(name)`` gives the keras model and the function a record traces,
so that a test can rebuild the same model and hold a replay against TF.
"""

import argparse
import os
import sys

os.environ.setdefault("KERAS_BACKEND", "tensorflow")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ENCODER = dict(layers=24, hidden=1024, heads=16, ffn=4096, vocab=30522)
RECORDS = ("resnet50", "encoder_causal", "encoder", "rank")


def resnet50():
    import tensorflow as tf
    model = tf.keras.applications.ResNet50(weights=None,
                                           classifier_activation=None)

    def loss_fn(images, labels):
        logits = model(images, training=True)
        loss = tf.reduce_mean(
            tf.nn.sparse_softmax_cross_entropy_with_logits(labels, logits))
        return loss, logits

    sig = [tf.TensorSpec([None, 224, 224, 3], tf.float32),
           tf.TensorSpec([None], tf.int32)]
    return model, loss_fn, sig


def encoder(causal, layers=24, hidden=1024, heads=16, ffn=4096,
            vocab=30522):
    import keras
    import tensorflow as tf
    ids = keras.Input((None,), dtype="int32", name="ids")
    h = keras.layers.Embedding(vocab, hidden, name="embed")(ids)
    for i in range(layers):
        a = keras.layers.MultiHeadAttention(
            heads, hidden // heads, name=f"l{i}_attn")(
                h, h, use_causal_mask=causal)
        h = keras.layers.LayerNormalization(epsilon=1e-12,
                                            name=f"l{i}_ln1")(h + a)
        f = keras.layers.Dense(ffn, activation="gelu", name=f"l{i}_ffn1")(h)
        f = keras.layers.Dense(hidden, name=f"l{i}_ffn2")(f)
        h = keras.layers.LayerNormalization(epsilon=1e-12,
                                            name=f"l{i}_ln2")(h + f)
    logits = keras.layers.Dense(vocab, name="head")(h)
    model = keras.Model(ids, logits)

    def loss_fn(ids, labels):
        logits = model(ids, training=True)
        return tf.reduce_mean(
            tf.nn.sparse_softmax_cross_entropy_with_logits(labels, logits))

    sig = [tf.TensorSpec([None, None], tf.int32),
           tf.TensorSpec([None, None], tf.int32)]
    return model, loss_fn, sig


def rank():
    import tensorflow as tf
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.tensorflow as hvd_tf
    if not hvd.is_initialized():
        hvd.init(device="cpu")

    def f(x):
        return (x * tf.cast(hvd_tf.rank_op(), tf.float32)
                + tf.cast(hvd_tf.size_op(), tf.float32))

    return None, f, [tf.TensorSpec([None], tf.float32)]


def build(name, **encoder_widths):
    """(keras model or None, traced function, input signature)."""
    if name == "resnet50":
        return resnet50()
    if name in ("encoder_causal", "encoder"):
        return encoder(name == "encoder_causal",
                       **{**ENCODER, **encoder_widths})
    if name == "rank":
        return rank()
    raise ValueError(f"unknown record {name!r}; one of {RECORDS}")


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join(REPO, "tests",
                                                 "torch_port_fixtures"))
    p.add_argument("--only", default=",".join(RECORDS))
    args = p.parse_args()
    import tensorflow as tf
    from horovod_tpu_torch.tensorflow.compile import (record_function,
                                                      save_record)
    os.makedirs(args.out, exist_ok=True)
    for name in args.only.split(","):
        tf.keras.utils.set_random_seed(0)
        _, fn, sig = build(name)
        path = os.path.join(args.out, f"tf_{name}.npz")
        save_record(record_function(fn, input_signature=sig), path)
        print(f"{path}: {os.path.getsize(path)} bytes", flush=True)


if __name__ == "__main__":
    main()
