"""Posed image dataset for evaluation targets (counterpart of
deblur_e_nerf_tpu/data/posed_images.py, without OpenCV).

Host-side loading of `views/transforms_{train,val,test}.json` plus image
files, with the reference's exact image and pose transforms
(reference: deblur_e_nerf/data/datasets.py:376-712):
  - alpha-over-white-background compositing in display or linear color space,
  - BGR->RGB for Bayer cameras / BGR->Gray for monochrome,
  - ADC-aware normalization to [0.5/2^D, 1 - 0.5/2^D] for quantized images vs
    `+ log_eps` for linear-color-space float renders,
  - OpenGL -> common camera convention pose conversion (right-multiply by
    diag(1, -1, -1)).

Images are read by `image_io.imread`, which returns what OpenCV's
`imread(..., IMREAD_UNCHANGED)` returns (BGR(A) order); OpenCV's BGR->RGB
becomes a channel flip (a single channel is repeated three times, as
OpenCV does) and its float32 BGR->gray the same weighted sum in float32.
"""

import glob
import json
import math
import os

import numpy as np

from . import events as events_data
from . import image_io

STAGES = ("train", "val", "test")
NORMALIZED_SAMPLE_ID_CHAR_LEN = 16
ACCEPTED_NUM_IMG_CHANNELS = (1, 3, 4)
# OpenGL camera frame (y up, z backward) -> common camera frame
# (y down, z forward)
T_COPENGL_CCOMMON_ORIENTATION = np.array(
    [[1, 0, 0], [0, -1, 0], [0, 0, -1]], dtype=np.float64
)

POSED_IMG_FOLDER_NAME = "views"
STAGE_TRANSFORMS_FILENAME_FORMAT_STR = "transforms_{}.json"
HORIZONTAL_FOV_KEY = "camera_angle_x"
INTRINSICS_KEY = "intrinsics"
BIT_DEPTH_KEY = "bit_depth"
IMG_METADATA_KEY = "frames"
IMG_PATH_KEY = "file_path"
IMG_EXPOSURE_TIME_KEY = "exposure_time"
IMG_GAIN_KEY = "gain"
IMG_POSE_KEY = "transform_matrix"

RENDERER_PARAMS_FILENAME = "renderer_params.npz"
INTERM_COLOR_SPACE_KEY = "interm_color_space"
LOG_EPS_KEY = "log_eps"


def posed_img_folder_path(root_directory):
    """Posed images live in the root dir or one level above it."""
    for path in (
        os.path.join(root_directory, POSED_IMG_FOLDER_NAME),
        os.path.join(root_directory, "..", POSED_IMG_FOLDER_NAME),
    ):
        if os.path.isdir(path):
            return path
    raise FileNotFoundError(
        f"no '{POSED_IMG_FOLDER_NAME}' folder found near {root_directory}"
    )


def load_stage_transforms(root_directory, stage):
    path = os.path.join(
        posed_img_folder_path(root_directory),
        STAGE_TRANSFORMS_FILENAME_FORMAT_STR.format(stage),
    )
    with open(path) as f:
        return json.load(f)


def load_renderer_params(root_directory):
    path = os.path.join(root_directory, RENDERER_PARAMS_FILENAME)
    if os.path.isfile(path):
        return np.load(path)
    return None


def normalize_sample_id(sample_id):
    """Pad to fixed length and encode as Unicode code points (int array)."""
    padded = sample_id.ljust(NORMALIZED_SAMPLE_ID_CHAR_LEN)
    return np.asarray([ord(c) for c in padded], dtype=np.int64)


def sample_id_to_str(code_points):
    if isinstance(code_points, str):
        return code_points.rstrip()
    return "".join(map(chr, np.asarray(code_points).tolist())).rstrip()


# OpenCV's BGR->gray weights (ITU-R BT.601), as float32
GRAY_WEIGHTS_BGR = np.array([0.114, 0.587, 0.299], dtype=np.float32)


def bgr_to_rgb(img):
    """OpenCV's COLOR_BGR2RGB on a stack of images (..., H, W[, C]): the
    first three channels reversed, a single channel repeated three
    times."""
    if img.ndim == 3:  # (N, H, W): one channel
        return np.repeat(img[..., None], 3, axis=-1)
    return img[..., 2::-1]


def bgr_to_gray(img):
    """OpenCV's COLOR_BGR2GRAY on float32 (..., H, W, 3): the weighted sum
    of the channels in float32."""
    w = GRAY_WEIGHTS_BGR
    return (img[..., 0] * w[0] + img[..., 1] * w[1]
            + img[..., 2] * w[2]).astype(np.float32)


class PosedImageDataset:
    def __init__(self, root_directory, stage, permutation_seed=None,
                 alpha_over_white_bg=False):
        assert stage in STAGES
        stage_transforms = load_stage_transforms(root_directory, stage)
        renderer_params = load_renderer_params(root_directory)
        calib = events_data.load_camera_calibration(root_directory)

        data = self._load_posed_imgs(root_directory, stage_transforms)
        data = self._transform_img(
            data, alpha_over_white_bg, stage_transforms, renderer_params,
            str(calib[events_data.BAYER_PATTERN_KEY]),
        )
        data = self._transform_pose(data)
        self.posed_imgs = data

        if permutation_seed is not None:
            n = len(data["img"])
            rng = np.random.Generator(np.random.Philox(permutation_seed))
            indices = rng.permutation(n)
            for key, value in data.items():
                if key != "intrinsics":
                    data[key] = value[indices]

    def _load_posed_imgs(self, root_directory, stage_transforms):
        data = {
            "sample_id": [],
            "img": [],
            "T_wc_position": [],
            "T_wc_orientation": [],
            "intrinsics": None,
        }
        image_metadatas = stage_transforms[IMG_METADATA_KEY]
        if image_metadatas:
            if IMG_EXPOSURE_TIME_KEY in image_metadatas[0]:
                data["exposure_time"] = []
            if IMG_GAIN_KEY in image_metadatas[0]:
                data["gain"] = []

        folder = posed_img_folder_path(root_directory)
        for meta in image_metadatas:
            sample_id = os.path.basename(meta[IMG_PATH_KEY])
            data["sample_id"].append(normalize_sample_id(sample_id))

            img_path = glob.glob(
                os.path.join(folder, meta[IMG_PATH_KEY] + ".*")
            )[0]
            img = image_io.imread(img_path)
            data["img"].append(img)

            T_wc = np.array(meta[IMG_POSE_KEY])
            data["T_wc_position"].append(T_wc[:3, 3])
            data["T_wc_orientation"].append(T_wc[:3, :3])

            if IMG_EXPOSURE_TIME_KEY in meta:
                data["exposure_time"].append(meta[IMG_EXPOSURE_TIME_KEY])
            if IMG_GAIN_KEY in meta:
                data["gain"].append(meta[IMG_GAIN_KEY])

        for key, value in data.items():
            if key != "intrinsics":
                data[key] = np.stack(value, axis=0)

        # intrinsics from horizontal FOV or an explicit matrix
        assert (HORIZONTAL_FOV_KEY in stage_transforms
                or INTRINSICS_KEY in stage_transforms)
        if HORIZONTAL_FOV_KEY in stage_transforms:
            H, W = data["img"].shape[1:3]
            horizontal_fov = stage_transforms[HORIZONTAL_FOV_KEY]
            focal_len = (W / 2) / math.tan(horizontal_fov / 2)
            data["intrinsics"] = np.array(
                [[focal_len, 0, W / 2 - 0.5],
                 [0, focal_len, H / 2 - 0.5],
                 [0, 0, 1]]
            )
        else:
            data["intrinsics"] = np.array(
                stage_transforms[INTRINSICS_KEY]
            )
        return data

    def _transform_img(self, data, alpha_over_white_bg, stage_transforms,
                       renderer_params, bayer_pattern):
        img = data["img"]
        is_quantized = np.issubdtype(img.dtype, np.unsignedinteger)
        is_synthetic = renderer_params is not None
        num_img_channels = 1 if img.ndim == 3 else img.shape[3]

        num_quantization_levels = None
        if is_quantized:
            if BIT_DEPTH_KEY in stage_transforms:
                num_quantization_levels = 2 ** stage_transforms[BIT_DEPTH_KEY]
            else:
                num_quantization_levels = np.iinfo(img.dtype).max + 1

        interm_color_space = None
        if is_synthetic:
            interm_color_space = str(
                renderer_params[INTERM_COLOR_SPACE_KEY]
            )

        assert (np.issubdtype(img.dtype, np.unsignedinteger)
                or np.issubdtype(img.dtype, np.floating))
        assert np.all(img >= 0)
        if is_synthetic:
            assert interm_color_space == (
                "display" if is_quantized else "linear"
            )
        else:
            assert is_quantized
        assert num_img_channels in ACCEPTED_NUM_IMG_CHANNELS
        if num_img_channels == 4:
            assert is_synthetic

        # alpha-over requires an alpha channel; the config flag is also set
        # for RGB/monochrome renders (where the model instead learns a
        # background radiance parameter) — those images pass through
        if alpha_over_white_bg and num_img_channels == 4:
            if interm_color_space == "display":
                alpha = img[..., 3] / (num_quantization_levels - 1)
                alpha = alpha[..., np.newaxis]
                img = (alpha * img[..., :3]
                       + (1 - alpha) * (num_quantization_levels - 1))
            elif interm_color_space == "linear":
                alpha = img[..., 3][..., np.newaxis]
                img = img[..., :3] + (1 - alpha)
        elif num_img_channels == 4:
            img = img[..., :3]

        img = img.astype(np.float32)

        if bayer_pattern != events_data.NULL_BAYER_PATTERN:
            img = bgr_to_rgb(img).transpose(0, 3, 1, 2)  # (N, 3, H, W) RGB
        elif num_img_channels >= 3:
            img = bgr_to_gray(img)

        # ADC-aware normalization: a D-bit sensor maps true analog values in
        # [x, x+1) to the code x, so code x represents x + 0.5
        if is_quantized:
            self.min_normalized_pixel_value = 0.5 / num_quantization_levels
            img = img / num_quantization_levels \
                + self.min_normalized_pixel_value
            self.max_normalized_pixel_value = (
                1 - self.min_normalized_pixel_value
            )
        else:
            self.min_normalized_pixel_value = float(
                renderer_params[LOG_EPS_KEY]
            )
            img = img + self.min_normalized_pixel_value
            self.max_normalized_pixel_value = float(img.max())

        data["img"] = img.astype(np.float32)
        return data

    @staticmethod
    def _transform_pose(data):
        data["T_wc_orientation"] = (
            data["T_wc_orientation"] @ T_COPENGL_CCOMMON_ORIENTATION
        )
        for key in ("T_wc_position", "T_wc_orientation", "intrinsics"):
            data[key] = np.asarray(data[key], dtype=np.float32)
        if "gain" in data:
            data["gain"] = np.asarray(data["gain"], dtype=np.float32)
        if "exposure_time" in data:
            data["exposure_time"] = np.asarray(
                data["exposure_time"], dtype=np.int64
            )
        return data

    def __len__(self):
        return len(self.posed_imgs["img"])
