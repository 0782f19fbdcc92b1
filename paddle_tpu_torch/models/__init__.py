"""The model zoo (counterpart of ``paddle_tpu/models/__init__.py``): the
reference's benchmark and book models on the DSL, each ``build`` returning
(cost, prediction) LayerOutputs for ``Topology`` and the trainer."""

from paddle_tpu_torch.models import mlp
from paddle_tpu_torch.models import alexnet
from paddle_tpu_torch.models import vgg
from paddle_tpu_torch.models import resnet
from paddle_tpu_torch.models import googlenet
from paddle_tpu_torch.models import text_lstm
from paddle_tpu_torch.models import seq2seq
from paddle_tpu_torch.models import ctr
from paddle_tpu_torch.models import word2vec
from paddle_tpu_torch.models import recommender
from paddle_tpu_torch.models import ssd
from paddle_tpu_torch.models import label_semantic_roles
from paddle_tpu_torch.models import ocr_ctc
from paddle_tpu_torch.models import transformer
