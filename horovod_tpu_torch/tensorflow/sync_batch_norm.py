"""Cross-rank synchronized batch normalization for TensorFlow on the
port's runtime (port of ``horovod_tpu/tensorflow/sync_batch_norm.py``;
reference: horovod/tensorflow/sync_batch_norm.py:151
``SyncBatchNormalization``).

Self-contained Keras layer (no tf.keras BatchNormalization internals —
those changed across Keras versions): global-batch statistics via a
py_function-bridged allreduce on the runtime's device in the forward
pass, and the chain rule's sum_dy / sum_dy_xmu allreduced inside a
``tf.custom_gradient`` backward, as the port's torch SyncBatchNorm does.
"""

from . import _eager, _spmd
from ..ops import collectives as _c
from ..ops import reduce_ops
from ..process_sets import global_process_set


def _tf():
    import tensorflow as tf
    return tf


def _py_allreduce(tensor, name):
    """Sum-allreduce of a TF tensor through the port's plane, with its
    static shape kept."""
    def fn(ts):
        return [_c.allreduce(ts[0], op=reduce_ops.Sum, name=name,
                             process_set=global_process_set)]

    return _eager(fn, [tensor], [tensor.dtype], shape_preserving=True)[0]


def SyncBatchNormalization(axis=-1, momentum=0.99, epsilon=1e-3,
                           center=True, scale=True, name=None, **kwargs):
    """Build the layer (function wrapper so importing this module never
    imports tensorflow; reference exposes a class — the returned object
    behaves identically)."""
    tf = _tf()

    class _SyncBatchNormalization(tf.keras.layers.Layer):
        def __init__(self):
            super().__init__(name=name, **kwargs)
            self.axis = axis
            self.momentum = momentum
            self.epsilon = epsilon
            self.center = center
            self.scale = scale

        def build(self, input_shape):
            dim = int(input_shape[self.axis])
            self.gamma = self.add_weight(
                name="gamma", shape=(dim,), initializer="ones",
                trainable=self.scale)
            self.beta = self.add_weight(
                name="beta", shape=(dim,), initializer="zeros",
                trainable=self.center)
            self.moving_mean = self.add_weight(
                name="moving_mean", shape=(dim,), initializer="zeros",
                trainable=False)
            self.moving_variance = self.add_weight(
                name="moving_variance", shape=(dim,), initializer="ones",
                trainable=False)
            super().build(input_shape)

        def _broadcast_shape(self, x):
            shape = [1] * len(x.shape)
            shape[self.axis] = x.shape[self.axis]
            return shape

        def call(self, inputs, training=False):
            x = inputs
            bshape = self._broadcast_shape(x)
            if not training or not _spmd():
                inv = tf.math.rsqrt(self.moving_variance + self.epsilon)
                out = (x - tf.reshape(self.moving_mean, bshape)) \
                    * tf.reshape(inv, bshape)
                return out * tf.reshape(self.gamma, bshape) \
                    + tf.reshape(self.beta, bshape)

            ndims = len(x.shape)
            ax = self.axis % ndims
            reduce_axes = [d for d in range(ndims) if d != ax]
            c = x.shape[ax]

            local_count = tf.cast(
                tf.size(x) / c, x.dtype)
            local_sum = tf.reduce_sum(x, axis=reduce_axes)
            local_sqsum = tf.reduce_sum(x * x, axis=reduce_axes)
            packed = tf.concat(
                [local_sum, local_sqsum, tf.reshape(local_count, (1,))],
                axis=0)
            packed = _py_allreduce(packed, f"tf_syncbn.fwd.{c}")
            total = packed[-1]
            mean = packed[:c] / total
            var = packed[c:2 * c] / total - mean * mean
            invstd = tf.math.rsqrt(var + self.epsilon)

            # Running stats (unbiased variance, reference semantics).
            unbiased = var * (total / tf.maximum(total - 1.0, 1.0))
            self.moving_mean.assign(
                self.moving_mean * self.momentum
                + mean * (1.0 - self.momentum))
            self.moving_variance.assign(
                self.moving_variance * self.momentum
                + unbiased * (1.0 - self.momentum))

            # Convert to tensors BEFORE the custom_gradient boundary:
            # captured tf.Variables would force the grad_fn to accept a
            # `variables` kwarg; with tensors the Variable->tensor read is
            # on the tape and dgamma/dbeta flow through normally.
            gamma = tf.convert_to_tensor(self.gamma)
            beta = tf.convert_to_tensor(self.beta)

            @tf.custom_gradient
            def _normalize(xin, g, b):
                xmu = xin - tf.reshape(mean, bshape)
                xhat = xmu * tf.reshape(invstd, bshape)
                out = xhat * tf.reshape(g, bshape) \
                    + tf.reshape(b, bshape)

                def grad(dy):
                    sum_dy = tf.reduce_sum(dy, axis=reduce_axes)
                    sum_dy_xmu = tf.reduce_sum(dy * xmu, axis=reduce_axes)
                    packed_g = tf.concat([sum_dy, sum_dy_xmu], axis=0)
                    packed_g = _py_allreduce(packed_g,
                                             f"tf_syncbn.bwd.{c}")
                    g_sum_dy = packed_g[:c]
                    g_sum_dy_xmu = packed_g[c:]
                    inv = tf.reshape(invstd, bshape)
                    dx = (dy
                          - tf.reshape(g_sum_dy, bshape) / total
                          - xmu * inv * inv
                          * tf.reshape(g_sum_dy_xmu, bshape) / total) \
                        * inv * tf.reshape(g, bshape)
                    dgamma = tf.reduce_sum(dy * xhat, axis=reduce_axes)
                    dbeta = sum_dy
                    return dx, dgamma, dbeta

                return out, grad

            return _normalize(x, gamma, beta)

    return _SyncBatchNormalization()
