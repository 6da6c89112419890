"""Shared Spark-DataFrame inference scaffolding for the estimator model
transformers (port of ``horovod_tpu/spark/_transform.py``): one
mapInPandas body, one pyspark gate, one output-width check. pyspark and
pandas are imported at the use."""

import numpy as np

from .data import stack_column


def require_pyspark(what):
    try:
        import pyspark
        return pyspark
    except ImportError as e:
        raise ImportError(
            f"{what} requires pyspark; use predict() for local numpy "
            "inference.") from e


def check_output_width(preds, output_cols):
    """A (rows, k) prediction can fill len(output_cols) columns only when
    k == len(output_cols) or k == 1 — anything else would silently write
    component 0 of a k-way output into the single column."""
    k = preds.shape[1]
    if k not in (1, len(output_cols)):
        raise ValueError(
            f"model produces {k} output components but output_cols has "
            f"{len(output_cols)} entries; pass output_cols naming one "
            "column per component (or reduce the output in the model)")


def materialize_df(df, store, num_proc):
    """DataFrame -> parquet shards in the store, at least one part file
    per rank (reference: horovod/spark/common/util.py prepare_data).
    Shared by the estimator flavors."""
    path = store.get_train_data_path()
    (df.repartition(max(num_proc, df.rdd.getNumPartitions()))
       .write.mode("overwrite").parquet(path))
    return path


def transform_with(df, feature_cols, output_cols, make_predict):
    """Append prediction columns to a Spark DataFrame via mapInPandas.
    ``make_predict()`` runs once per executor partition stream and
    returns ``fn(list_of_feature_arrays) -> (rows, k) ndarray``."""
    require_pyspark("transform")
    import pandas as pd
    from pyspark.sql.types import DoubleType, StructField, StructType

    schema = StructType(df.schema.fields + [
        StructField(c, DoubleType()) for c in output_cols])

    def infer(iterator):
        predict = make_predict()
        for pdf in iterator:
            feats = [stack_column(pdf[c].to_numpy())
                     for c in feature_cols]
            preds = np.asarray(predict(feats)).reshape(len(pdf), -1)
            check_output_width(preds, output_cols)
            out = pdf.copy()
            for i, c in enumerate(output_cols):
                col = preds if preds.shape[1] == 1 else preds[:, i:i + 1]
                out[c] = pd.Series(col.ravel().astype(float),
                                   index=pdf.index)
            yield out

    return df.mapInPandas(infer, schema=schema)
