"""NLP: embedding models + text pipeline (reference
`deeplearning4j-nlp-parent/`, §2.5 of SURVEY.md).

Counterpart of `deeplearning4j_tpu/nlp`. Host/device split:
tokenization, vocab construction, Huffman coding, and training-pair
generation are host-side (pure Python/numpy, like the reference's
producer threads `SequenceVectors.java:246-260`, and equal to the JAX
package's); the skip-gram/CBOW/GloVe inner loops, the reference's native
`AggregateSkipGram` / `AggregateCBOW` C++ ops (`SkipGram.java:258`), are
torch gathers and `index_add_` scatters on the card over large batched
pair tensors (`nlp/kernels.py`), so the device sees one big segment of
work per batch instead of per-word calls.
"""
from deeplearning4j_tpu_torch.nlp.tokenization import (  # noqa: F401
    CommonPreprocessor,
    DefaultTokenizerFactory,
    NGramTokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.sentence_iterator import (  # noqa: F401
    BasicLineIterator,
    CollectionSentenceIterator,
)
from deeplearning4j_tpu_torch.nlp.vocab import AbstractCache, VocabConstructor, VocabWord  # noqa: F401
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec  # noqa: F401
from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors  # noqa: F401
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import ParagraphVectors  # noqa: F401
from deeplearning4j_tpu_torch.nlp.glove import Glove  # noqa: F401
from deeplearning4j_tpu_torch.nlp.serializer import WordVectorSerializer  # noqa: F401
from deeplearning4j_tpu_torch.nlp.bagofwords import BagOfWordsVectorizer, TfidfVectorizer  # noqa: F401
