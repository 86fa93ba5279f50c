/* Pure-C inference API (the paddle/capi equivalent, SURVEY.md §2.14:
 * capi/gradient_machine.h:36 paddle_gradient_machine_create_for_inference),
 * the port of paddle_tpu/native/capi.h: the same symbols, so a C program
 * builds unchanged against either header.
 *
 * The library embeds CPython and runs paddle_tpu_torch.capi_runtime, on the
 * card unless PADDLE_TPU_TORCH_CAPI_PLACE=cpu.  Thread-safe via the GIL.
 *
 * Typical flow:
 *   paddle_capi_init(NULL);
 *   int64_t eng;
 *   paddle_inference_create("/path/to/saved_model", &eng);
 *   paddle_inference_set_input(eng, "img", data, shape, 4, PD_FLOAT32);
 *   int n_out; paddle_inference_run(eng, &n_out);
 *   int64_t shape[8]; int rank;
 *   paddle_inference_output_shape(eng, 0, shape, 8, &rank);
 *   paddle_inference_output_data(eng, 0, buf, buf_bytes);
 *   paddle_inference_release(eng);
 *   paddle_capi_shutdown();
 */
#ifndef PADDLE_TPU_CAPI_H
#define PADDLE_TPU_CAPI_H

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef enum {
  PD_FLOAT32 = 0,
  PD_INT64 = 1,
  PD_INT32 = 2,
  PD_FLOAT64 = 3,
} paddle_dtype;

typedef enum {
  PD_OK = 0,
  PD_ERROR = -1,         /* details via paddle_capi_last_error() */
  PD_NOT_INITIALIZED = -2,
} paddle_status;

/* Initialize the embedded interpreter (no-op when already inside Python).
 * `python_path_extra` (may be NULL) is appended to sys.path so the host app
 * can point at the paddle_tpu_torch checkout. */
int paddle_capi_init(const char* python_path_extra);

/* Finalize the embedded interpreter iff this library created it (no-op when
 * running inside a host Python process). */
int paddle_capi_shutdown(void);

/* Last error message for this thread's most recent failing call. */
const char* paddle_capi_last_error(void);

/* Load a saved inference model directory (fluid.io.save_inference_model
 * layout: __model__ + params). Writes an engine handle to *out. */
int paddle_inference_create(const char* model_dir, int64_t* out);

/* Stage one named input: raw buffer + shape (row-major). */
int paddle_inference_set_input(int64_t engine, const char* name,
                               const void* data, const int64_t* shape,
                               int rank, paddle_dtype dtype);

/* Execute; *n_outputs receives the fetch count. */
int paddle_inference_run(int64_t engine, int* n_outputs);

/* Output geometry: writes up to max_rank dims and the true rank. */
int paddle_inference_output_shape(int64_t engine, int index, int64_t* shape,
                                  int max_rank, int* rank);

int paddle_inference_output_dtype(int64_t engine, int index,
                                  paddle_dtype* dtype);

/* Copy output payload into buf (buf_bytes must cover it; returns the number
 * of bytes written, or a negative paddle_status). */
int64_t paddle_inference_output_data(int64_t engine, int index, void* buf,
                                     int64_t buf_bytes);

int paddle_inference_release(int64_t engine);

#ifdef __cplusplus
}
#endif

#endif /* PADDLE_TPU_CAPI_H */
